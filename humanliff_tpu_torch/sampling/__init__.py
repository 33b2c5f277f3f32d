"""Layer-wise progressive generation."""
