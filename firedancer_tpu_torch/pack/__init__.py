"""pack: the leader-side transaction scheduler (hot loop #2); a copy
of the JAX package's pack/.

Re-expression of the reference's fd_pack (ref: src/disco/pack/fd_pack.h,
fd_pack.c:1760 fd_pack_schedule_impl, :2477 schedule_next_microblock;
conflict sets src/disco/pack/fd_pack_bitset.h:1-60): maintain a
priority-ordered pool of pending transactions and emit microblocks of
mutually non-conflicting transactions to parallel bank tiles under
consensus cost limits.
"""
from .scheduler import PackScheduler, PackLimits, TxnMeta  # noqa: F401
