"""Measurement scripts of the port, run as `python -m
firedancer_tpu_torch.tools.<name>`; nothing in the package imports
them."""
