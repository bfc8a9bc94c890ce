"""funk: fork-aware key-value store (prepare / publish / cancel); the
port's copy of the JAX package's funk/funk.py. The shm store
(funk/shmfunk.py) comes with the exec tile family, ROADMAP.md queue A
item 5.

Re-expression of the reference's funk database
(ref: src/funk/fd_funk.h:4-90 — record table + in-preparation
transaction tree; src/funk/fd_funk_txn.h — fork management APIs).
"""
from .funk import Funk, FunkTxnError, key32  # noqa: F401
