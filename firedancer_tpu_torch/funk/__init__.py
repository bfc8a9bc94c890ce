"""funk: fork-aware key-value store (prepare / publish / cancel); the
port's copies of the JAX package's funk/funk.py and funk/shmfunk.py
(the shm store the exec tile family shares).

Re-expression of the reference's funk database
(ref: src/funk/fd_funk.h:4-90 — record table + in-preparation
transaction tree; src/funk/fd_funk_txn.h — fork management APIs).
"""
from .funk import Funk, FunkTxnError, key32  # noqa: F401
from .shmfunk import (  # noqa: F401
    FUNK_DEFAULTS, ShmFunk, WireFunk, make_funk, normalize_funk,
)
