"""Host-side (numpy) ray generation and the procedural orbit cameras."""
