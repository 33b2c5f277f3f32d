"""Parameter converters from the JAX package's layouts."""
