"""flamenco: the runtime's state commitments, the gossip wire codec and
the epoch leader schedule (copies of the bank hash, gossip_wire and
leaders of the JAX package's flamenco/)."""
