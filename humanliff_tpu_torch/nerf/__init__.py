"""Tri-plane NeRF decoder and exact volume renderer."""
