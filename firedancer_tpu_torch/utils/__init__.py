"""Host utilities copied from the JAX package."""
