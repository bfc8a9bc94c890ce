"""Wire formats copied from the JAX package."""
