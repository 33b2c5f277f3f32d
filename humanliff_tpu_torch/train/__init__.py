"""The sampling file contract of the JAX package's checkpoints."""
