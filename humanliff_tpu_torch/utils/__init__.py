"""Image and video writers."""
