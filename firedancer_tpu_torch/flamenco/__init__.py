"""flamenco: the runtime's state commitments and the gossip wire codec
(copies of the bank hash and gossip_wire of the JAX package's
flamenco/)."""
