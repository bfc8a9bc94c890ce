"""replay: the conflict DAG the wave executor stages blocks through (the
port's copy of the JAX package's replay/rdisp.py `ConflictDag`)."""
from .rdisp import ConflictDag  # noqa: F401
