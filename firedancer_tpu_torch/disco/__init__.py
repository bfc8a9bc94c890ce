"""Tile plumbing copied from the JAX package."""
