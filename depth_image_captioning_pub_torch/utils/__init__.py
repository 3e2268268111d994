"""Weight loading from the JAX package's parameter trees."""
