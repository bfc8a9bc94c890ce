"""accdb v2 — hot funk + cold groove, one account-DB facade (copy of the
JAX package's svm/accdb_cold.py).

The reference's accdb v2 layers funk (hot, fork-aware) over a disk
store reached through a vtable (ref: src/flamenco/accdb/
fd_accdb_impl_v2.c over funk+vinyl; fd_accdb_user.h keeps the caller
API identical between v1 and v2). Same shape here: `AccDbCold`
IS an `AccDb` (every handle/fork semantic inherited), with a groove
cold store underneath:

  * peek/open_* fall through to groove on a hot miss; a cold hit is
    PROMOTED into the funk ROOT (cold records only ever hold rooted
    state, so root promotion preserves fork visibility rules).
  * evict(pubkey) moves a ROOTED account to disk and drops it from
    the hot map — the working-set valve. Eviction refuses accounts
    with unpublished fork state (fork overlays must never be silently
    flattened into the cold store).
  * restart: a fresh AccDbCold over an empty funk serves everything
    the previous generation evicted (groove's scan recovery).

Cold record encoding: lamports u64 | executable u8 | rent_epoch u64 |
owner 32 | data (length-implicit) — little-endian, versioned by the
groove volume magic.
"""
from __future__ import annotations

import struct

from ..funk.funk import key32
from ..groove import GrooveStore
from .accdb import AccDb, Account

_META = "<QBQ32s"
_META_SZ = struct.calcsize(_META)


def account_to_bytes(a: Account) -> bytes:
    return struct.pack(_META, a.lamports, 1 if a.executable else 0,
                       a.rent_epoch, bytes(a.owner)) + bytes(a.data)


def account_from_bytes(b: bytes) -> Account:
    lam, ex, rent, owner = struct.unpack_from(_META, b, 0)
    return Account(lamports=lam, data=bytes(b[_META_SZ:]),
                   owner=owner, executable=bool(ex), rent_epoch=rent)


class ColdEvictError(RuntimeError):
    pass


class AccDbCold(AccDb):
    def __init__(self, funk, cold_dir: str):
        super().__init__(funk)
        self.cold = GrooveStore(cold_dir)
        self.cold_stats = {"hits": 0, "promoted": 0, "evicted": 0}

    # -- read path: hot, then cold ------------------------------------------

    def peek(self, xid, pubkey: bytes) -> Account | None:
        a = super().peek(xid, pubkey)
        if a is not None:
            return a
        raw = self.cold.get(pubkey)
        if raw is None:
            return None
        acct = account_from_bytes(bytes(raw))
        # promote into the ROOT: cold state is rooted state, and root
        # records are visible through every fork overlay. The cold
        # copy is DELETED at promotion — an account lives hot XOR
        # cold, so later hot updates/deletions can never be shadowed
        # by a stale cold record after a restart (r4 review)
        self.funk.rec_write(None, key32(pubkey), acct)
        self.cold.delete(pubkey)
        self.cold_stats["hits"] += 1
        self.cold_stats["promoted"] += 1
        return super().peek(xid, pubkey)

    # -- the working-set valve ----------------------------------------------

    def _has_fork_state(self, pubkey: bytes) -> bool:
        for xid in list(getattr(self.funk, "_txns", {})):
            if pubkey in self.funk.txn_recs(xid):
                return True
        return False

    def evict(self, pubkey: bytes, flush: bool = True):
        """Move a ROOTED account to the cold store. Refuses when any
        in-preparation fork carries state for the key (eviction must
        not change what any fork can observe once it publishes)."""
        a = self.funk.rec_query(None, pubkey)
        if a is None:
            raise ColdEvictError("no rooted record to evict")
        if self._has_fork_state(pubkey):
            raise ColdEvictError("key has unpublished fork state")
        acct = a if isinstance(a, Account) else Account(lamports=a)
        self.cold.put(pubkey, account_to_bytes(acct))
        if flush:
            self.cold.flush()
        self.funk.rec_remove(None, key32(pubkey))
        self.cold_stats["evicted"] += 1

    def evict_larger_than(self, data_len: int) -> int:
        """Bulk valve: push every rooted account with data above the
        threshold to disk (skipping keys with live fork state).
        Returns the count evicted. One durability flush for the whole
        sweep."""
        n = 0
        for key, val in list(self.funk.root_items().items()):
            data = val.data if isinstance(val, Account) else b""
            if len(data) <= data_len:
                continue
            try:
                self.evict(key, flush=False)
            except ColdEvictError:
                continue              # fork-dirty key: skip
            n += 1
        if n:
            self.cold.flush()
        return n

    def remove(self, xid, pubkey: bytes):
        """Delete an account through the facade — BOTH layers. Direct
        funk.rec_remove on a key that was evicted (and never promoted)
        would leave a cold copy to resurrect; all deletions of
        possibly-cold keys must come through here."""
        self.cold.delete(pubkey)
        self.funk.rec_remove(xid, key32(pubkey))

    def close(self):
        self.cold.close()
