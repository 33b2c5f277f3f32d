"""Layer-wise progressive generation, Picard sampling and tri-plane views."""
