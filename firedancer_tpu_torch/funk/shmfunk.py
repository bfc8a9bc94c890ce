"""Shm-resident funk: the fork tree re-expressed over the wksp ABI (the
port's copy of the JAX package's funk/shmfunk.py).

The in-process `Funk` (funk.py) is a dict tree — correct, but it chains
the whole execution path to ONE Python process. The reference backs the
same prepare/cancel/publish semantics with relocatable shared-memory
maps precisely so many tiles can read and write accounts concurrently
(ref: src/funk/fd_funk.h:28-90, src/flamenco/accdb/). `ShmFunk` is that
shape: the record tree lives in a carved store region (native/fdtpu.cc
— txn slot table + record map + size-class heap, serialized on a
dead-owner-stealing spinlock), and this class is a byte-compatible
`Funk` API facade over it, so `svm/accdb.py`, the executor, and the
conformance/bank-hash suites run unchanged on either backend.

Two layers of identity:

  * Python callers use any hashable xid (slots, strings, tuples) — the
    facade interns them to u64 wire xids (assigned from 1; 0 is the
    published root). The intern table is per-process; CROSS-process
    users (exec tiles) exchange the raw u64 over rings and talk to the
    store through `raw` (the runtime.Store view) directly.
  * Values are tag-framed bytes: 0 = bare int lamports (u64 LE, the
    legacy genesis path), 1 = accdb Account (fixed header + var data),
    2 = pickle (sysvars, stake state, anything else) — decode always
    reconstructs the typed record, so AccDb's peek/open_rw contracts
    hold verbatim.

Config rides the topology as a `[funk]` section (normalize_funk is the
one validator: config load and topo.build call it):

    [funk]
    backend = "shm"       # "process" (dict tree) | "shm" (carved store)
    rec_max = 4096        # record slots
    txn_max = 256         # in-preparation txn slots
    heap_mb = 16          # value heap
"""
from __future__ import annotations

import os
import pickle
import struct

from .funk import MAX_FORK_DEPTH, FunkTxnError

FUNK_DEFAULTS = {
    "backend": "process",
    "rec_max": 4096,
    "txn_max": 256,
    "heap_mb": 16,
}
FUNK_BACKENDS = ("process", "shm")

_TAG_INT, _TAG_ACCT, _TAG_PICKLE = 0, 1, 2
_ACCT_HDR = struct.Struct("<Q32sBQ")      # lamports, owner, exec, rent_epoch


def _suggest(key, candidates) -> str:
    """did-you-mean suffix for an unknown key or value ('' if none)."""
    import difflib
    close = difflib.get_close_matches(str(key), sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_funk(spec) -> dict:
    """Validate + default-fill a [funk] table. Same fail-before-launch
    stance as [shed]/[trace]: raises ValueError with a did-you-mean."""
    out = dict(FUNK_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"funk spec must be a table, got {spec!r}")
    unknown = set(spec) - set(FUNK_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown funk key(s) {sorted(unknown)}"
                         + _suggest(key, FUNK_DEFAULTS))
    out.update(spec)
    if out["backend"] not in FUNK_BACKENDS:
        raise ValueError(
            f"funk.backend must be one of {FUNK_BACKENDS}, got "
            f"{out['backend']!r}" + _suggest(out["backend"],
                                             FUNK_BACKENDS))
    for key in ("rec_max", "txn_max"):
        out[key] = int(out[key])
        if out[key] < 16:
            raise ValueError(f"funk.{key} must be >= 16, got {out[key]}")
    out["heap_mb"] = int(out["heap_mb"])
    if out["heap_mb"] < 1:
        raise ValueError(
            f"funk.heap_mb must be >= 1, got {out['heap_mb']}")
    return out


def encode_value(val) -> bytes:
    """Typed funk value -> tag-framed bytes (the store's wire form)."""
    from ..svm.accdb import Account
    if isinstance(val, bool):             # bool is an int; don't alias
        return bytes([_TAG_PICKLE]) + pickle.dumps(val)
    if isinstance(val, int) and 0 <= val < (1 << 64):
        return bytes([_TAG_INT]) + struct.pack("<Q", val)
    if isinstance(val, Account):
        data = bytes(val.data)
        return (bytes([_TAG_ACCT])
                + _ACCT_HDR.pack(val.lamports, bytes(val.owner),
                                 1 if val.executable else 0,
                                 val.rent_epoch)
                + data)
    return bytes([_TAG_PICKLE]) + pickle.dumps(val)


def decode_value(buf: bytes):
    from ..svm.accdb import Account
    tag = buf[0]
    if tag == _TAG_INT:
        return struct.unpack_from("<Q", buf, 1)[0]
    if tag == _TAG_ACCT:
        lam, owner, ex, rent = _ACCT_HDR.unpack_from(buf, 1)
        return Account(lamports=lam, data=buf[1 + _ACCT_HDR.size:],
                       owner=owner, executable=bool(ex), rent_epoch=rent)
    return pickle.loads(buf[1:])


class ShmFunk:
    """Funk-API facade over a shm store region.

    Standalone mode (no wksp): creates a private workspace sized to the
    store footprint — the conformance/bank-hash suites and any single
    process wanting crash-consistent account state. Attach mode (wksp +
    off): joins a region carved by topo.build (plan["funk"]), sharing
    the tree with the resolv/exec tile family.
    """

    def __init__(self, wksp=None, off: int | None = None,
                 rec_max: int = 4096, txn_max: int = 256,
                 heap_sz: int = 1 << 24, name: str | None = None):
        from ..runtime import Store, Workspace
        self._own_wksp = None
        if wksp is None:
            fp = Store.footprint(rec_max, txn_max, heap_sz)
            name = name or f"/fdtt_funk_{os.getpid()}_{id(self):x}"
            wksp = Workspace(name, fp + 4096)
            self._own_wksp = wksp
        self.wksp = wksp
        self.raw = Store(wksp, off=off, rec_max=rec_max,
                         txn_max=txn_max, heap_sz=heap_sz)
        self.off = self.raw.off
        # hashable xid <-> u64 wire xid interning (per-process; the
        # store itself only ever sees the u64s)
        self._xid_to_u64: dict = {}
        self._u64_to_xid: dict = {}
        self._next_xid = 1
        self.last_publish = None

    # -- lifecycle ----------------------------------------------------------

    def close(self, unlink: bool = False):
        if self._own_wksp is not None:
            name = self._own_wksp.name
            self._own_wksp.close()
            if unlink:
                self._own_wksp.unlink()
            self._own_wksp = None

    def __del__(self):                    # best-effort shm hygiene
        try:
            self.close(unlink=True)
        except Exception:                 # noqa: BLE001 — teardown race
            pass

    # -- xid interning -------------------------------------------------------

    def intern_xid(self, xid) -> int:
        """Hashable xid -> wire u64 (0 for None/root). The u64 is what
        crosses rings to the exec tiles."""
        if xid is None:
            return 0
        u = self._xid_to_u64.get(xid)
        if u is None:
            u = self._next_xid
            self._next_xid += 1
            self._xid_to_u64[xid] = u
            self._u64_to_xid[u] = xid
        return u

    def _lookup(self, xid) -> int:
        """Like intern_xid but for paths that must NOT create: unknown
        xids raise the funk error contract."""
        if xid is None:
            return 0
        u = self._xid_to_u64.get(xid)
        if u is None or not self.raw.txn_exists(u):
            raise FunkTxnError(f"unknown txn {xid!r}")
        return u

    def _forget(self, u64: int):
        xid = self._u64_to_xid.pop(u64, None)
        if xid is not None:
            self._xid_to_u64.pop(xid, None)

    def _gc_interned(self):
        """Drop intern entries whose store txn is gone (publish/cancel
        retire whole subtrees store-side)."""
        for u in [u for u in self._u64_to_xid
                  if not self.raw.txn_exists(u)]:
            self._forget(u)

    # -- transaction tree ----------------------------------------------------

    def txn_prepare(self, parent_xid, xid):
        if xid is None:
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        pu = self._lookup(parent_xid) if parent_xid is not None else 0
        if xid in self._xid_to_u64 \
                and self.raw.txn_exists(self._xid_to_u64[xid]):
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        u = self.intern_xid(xid)
        rc = self.raw.txn_prepare(pu, u)
        if rc == -1:
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        if rc == -2:
            raise FunkTxnError(f"unknown parent {parent_xid!r}")
        if rc == -3:
            raise FunkTxnError("fork depth limit")
        if rc != 0:
            raise FunkTxnError(f"store txn table full (rc {rc})")
        return xid

    def txn_cancel(self, xid):
        u = self._lookup(xid)
        self.raw.txn_cancel(u)
        self._gc_interned()

    def txn_publish(self, xid):
        u = self._lookup(xid)
        rc = self.raw.txn_publish(u)
        if rc != 0:
            raise FunkTxnError(f"publish failed (rc {rc})")
        self._gc_interned()
        self.last_publish = xid

    def txn_is_prepared(self, xid) -> bool:
        u = self._xid_to_u64.get(xid)
        return u is not None and self.raw.txn_exists(u)

    def txn_children(self, xid) -> list:
        u = 0 if xid is None else self._lookup(xid)
        kids = self.raw.txn_children(u)
        # children prepared by OTHER processes have no local intern
        # entry; surface the raw u64 (the wire identity) for them
        return [self._u64_to_xid.get(k, k) for k in kids]

    # -- records -------------------------------------------------------------

    def rec_write(self, xid, key: bytes, val):
        u = 0 if xid is None else self._lookup(xid)
        rc = self.raw.put(u, bytes(key), encode_value(val))
        if rc != 0:
            raise MemoryError(f"shm funk store full (rc {rc}): raise "
                              f"[funk] rec_max/heap_mb")

    def rec_remove(self, xid, key: bytes):
        u = 0 if xid is None else self._lookup(xid)
        rc = self.raw.put(u, bytes(key), None)
        if rc != 0:
            raise MemoryError(f"shm funk store full (rc {rc})")

    def rec_query(self, xid, key: bytes):
        u = 0 if xid is None else self._lookup(xid)
        buf = self.raw.get(u, bytes(key))
        return None if buf is None else decode_value(buf)

    def root_items(self) -> dict:
        return {k: decode_value(v)
                for k, v in self.raw.iter_layer(0) if v is not None}

    def txn_recs(self, xid) -> dict:
        u = self._lookup(xid)
        return {k: (None if v is None else decode_value(v))
                for k, v in self.raw.iter_layer(u)}

    def items_at(self, xid) -> dict:
        out = {k: decode_value(v)
               for k, v in self.raw.iter_layer(0) if v is not None}
        if xid is None:
            return out
        chain = []
        u = self._lookup(xid)
        depth = 0
        while u:
            chain.append(u)
            u = max(self.raw.txn_parent(u), 0)
            depth += 1
            if depth > MAX_FORK_DEPTH:
                break
        for layer in reversed(chain):        # oldest ancestor first
            for k, v in self.raw.iter_layer(layer):
                if v is None:
                    out.pop(k, None)
                else:
                    out[k] = decode_value(v)
        return out


class WireFunk:
    """Funk-API facade over a JOINED store region where xids ARE the
    wire u64s (no per-process interning) — the resolv/exec tile view.

    The bank owns the fork lifecycle: it prepares the wave fork,
    broadcasts the u64 xid in the dispatch frames, and publishes after
    every exec tile reported completion. Exec tiles therefore see an
    ALREADY-prepared fork: txn_prepare here is idempotent (an existing
    xid is a no-op), so the WaveExecutor's stage->dispatch->finalize
    seam runs unchanged on either side of the ring. Conflict groups
    are account-disjoint across tiles, so concurrent rec_writes into
    the same fork layer never touch the same key; the store's one
    dead-owner-stealing lock serializes the map surgery itself."""

    def __init__(self, wksp, off: int, rec_max: int = 4096,
                 txn_max: int = 256, heap_sz: int = 1 << 24):
        from ..runtime import Store
        self.wksp = wksp
        self.raw = Store(wksp, off=off, rec_max=rec_max,
                         txn_max=txn_max, heap_sz=heap_sz)
        self.off = off
        self.last_publish = None

    @classmethod
    def from_plan(cls, wksp, plan_funk: dict) -> "WireFunk":
        """Join the store topo.build carved (plan["funk"])."""
        return cls(wksp, off=plan_funk["off"],
                   rec_max=plan_funk["rec_max"],
                   txn_max=plan_funk["txn_max"],
                   heap_sz=plan_funk["heap_sz"])

    @staticmethod
    def _u(xid) -> int:
        if xid is None:
            return 0
        return int(xid)

    def txn_prepare(self, parent_xid, xid):
        u = self._u(xid)
        if u == 0:
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        if self.raw.txn_exists(u):
            return xid                 # bank prepared it: idempotent
        rc = self.raw.txn_prepare(self._u(parent_xid), u)
        if rc == -1:
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        if rc == -2:
            raise FunkTxnError(f"unknown parent {parent_xid!r}")
        if rc == -3:
            raise FunkTxnError("fork depth limit")
        if rc != 0:
            raise FunkTxnError(f"store txn table full (rc {rc})")
        return xid

    def txn_cancel(self, xid):
        u = self._u(xid)
        if u == 0 or not self.raw.txn_exists(u):
            raise FunkTxnError(f"unknown txn {xid!r}")
        self.raw.txn_cancel(u)

    def txn_publish(self, xid):
        u = self._u(xid)
        if u == 0 or not self.raw.txn_exists(u):
            raise FunkTxnError(f"unknown txn {xid!r}")
        rc = self.raw.txn_publish(u)
        if rc != 0:
            raise FunkTxnError(f"publish failed (rc {rc})")
        self.last_publish = xid

    def txn_is_prepared(self, xid) -> bool:
        u = self._u(xid)
        return u != 0 and self.raw.txn_exists(u)

    def rec_write(self, xid, key: bytes, val):
        rc = self.raw.put(self._u(xid), bytes(key), encode_value(val))
        if rc != 0:
            raise MemoryError(f"shm funk store full (rc {rc}): raise "
                              f"[funk] rec_max/heap_mb")

    def rec_remove(self, xid, key: bytes):
        rc = self.raw.put(self._u(xid), bytes(key), None)
        if rc != 0:
            raise MemoryError(f"shm funk store full (rc {rc})")

    def rec_query(self, xid, key: bytes):
        buf = self.raw.get(self._u(xid), bytes(key))
        return None if buf is None else decode_value(buf)

    def root_items(self) -> dict:
        return {k: decode_value(v)
                for k, v in self.raw.iter_layer(0) if v is not None}

    def txn_recs(self, xid) -> dict:
        """The fork layer's own records (deletes as None) — what the
        bank-hash delta scan (flamenco/bank_hash.apply_txn_delta) walks
        before publish; the replay scheduler hashes every slot through
        this exact seam."""
        u = self._u(xid)
        if u == 0 or not self.raw.txn_exists(u):
            raise FunkTxnError(f"unknown txn {xid!r}")
        return {k: (None if v is None else decode_value(v))
                for k, v in self.raw.iter_layer(u)}


def make_funk(cfg: dict | None = None, wksp=None, off: int | None = None):
    """[funk] config -> a funk instance of the configured backend. The
    topology path passes (wksp, off) from plan["funk"]; standalone
    callers get a private segment."""
    cfg = normalize_funk(cfg)
    if cfg["backend"] == "process":
        from .funk import Funk
        return Funk()
    return ShmFunk(wksp=wksp, off=off, rec_max=cfg["rec_max"],
                   txn_max=cfg["txn_max"],
                   heap_sz=cfg["heap_mb"] << 20)
