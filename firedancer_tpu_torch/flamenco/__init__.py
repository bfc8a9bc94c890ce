"""flamenco: the runtime's state commitments (copy of the bank hash of
the JAX package's flamenco/)."""
