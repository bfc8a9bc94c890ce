"""groove: the cold account store (copy of the JAX package's groove/)."""
from .groove import GrooveError, GrooveStore  # noqa: F401
