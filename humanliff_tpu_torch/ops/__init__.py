"""Render ops and the fused decoder kernel wrapper."""
