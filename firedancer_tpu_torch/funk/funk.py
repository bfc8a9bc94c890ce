"""Fork-aware KV store with an in-preparation transaction tree (copy of
the JAX package's funk/funk.py).

Semantics contract (ref: src/funk/fd_funk.h:28-90):

* The "root" holds the last-published state. In-preparation
  transactions form a tree whose root children fork off the published
  state; a transaction's uncommitted updates shadow its ancestors'
  (ref: fd_funk.h "queries ... will observe the transaction's updates,
  its ancestors' updates and the last published state").
* prepare(parent, xid): add a leaf-or-branch child. Forks: a parent may
  have many children (competing forks of that parent).
* cancel(xid): discard the transaction AND all its descendants
  (ref: fd_funk_txn_cancel — cancels the whole subtree).
* publish(xid): make the transaction permanent. All its ancestors are
  published first (their updates fold into root in order), and every
  competing transaction (anything not descended from the published one)
  is cancelled (ref: fd_funk_txn_publish — "first publishes its
  ancestors and cancels any competing transaction histories").
* Record deletion is a tombstone so a child's remove shadows an
  ancestor's value (ref: fd_funk_rec REMOVE semantics).

The reference backs this with relocatable shared-memory maps for O(1)
query regardless of fork depth; here queries walk the ancestor chain
(depth capped like the reference's FD_FUNK_TXN_DEPTH_MAX-style limits,
accdb fork depth <= 128 — src/flamenco/accdb/) — the exec-path accdb
cache goes in front of this when the runtime lands.
"""
from __future__ import annotations

MAX_FORK_DEPTH = 128

KEY_WIDTH = 32

_TOMBSTONE = object()


def key32(key: bytes) -> bytes:
    """Width-normalizing gate for record keys headed into a write api.

    The native shm store ABI (and the reference's funk record map)
    reads EXACTLY 32 key bytes; a shorter python buffer gets hashed
    with per-process trailing garbage, so the record lands under a key
    no other tile can derive and the write is silently lost to the
    rest of the topology (the r17 follower-gate wedge). Route every
    key whose width is not structurally obvious through this helper —
    the short-key lint rule accepts it as proof."""
    if len(key) != KEY_WIDTH:
        raise ValueError(
            f"funk record keys are exactly {KEY_WIDTH} bytes, got "
            f"{len(key)}")
    return key


class FunkTxnError(RuntimeError):
    pass


class _Txn:
    __slots__ = ("xid", "parent", "children", "recs")

    def __init__(self, xid, parent):
        self.xid = xid
        self.parent = parent          # _Txn or None (child of root)
        self.children: list[_Txn] = []
        self.recs: dict[bytes, object] = {}


class Funk:
    """Single-writer fork tree. xids are any hashable (the reference
    uses 32-byte ids; slots work naturally)."""

    def __init__(self):
        self._root: dict[bytes, object] = {}
        self._txns: dict[object, _Txn] = {}
        self.last_publish = None       # xid of last published txn

    # -- transaction tree --------------------------------------------------

    def txn_prepare(self, parent_xid, xid):
        if xid in self._txns or xid is None:
            raise FunkTxnError(f"xid {xid!r} already in preparation")
        if parent_xid is None:
            parent = None
        else:
            parent = self._txns.get(parent_xid)
            if parent is None:
                raise FunkTxnError(f"unknown parent {parent_xid!r}")
        depth = 1
        p = parent
        while p is not None:
            depth += 1
            p = p.parent
        if depth > MAX_FORK_DEPTH:
            raise FunkTxnError("fork depth limit")
        t = _Txn(xid, parent)
        if parent is not None:
            parent.children.append(t)
        self._txns[xid] = t
        return xid

    def _drop_subtree(self, t: _Txn):
        for c in t.children:
            self._drop_subtree(c)
        del self._txns[t.xid]

    def txn_cancel(self, xid):
        """Cancel xid and all descendants (ref: fd_funk_txn_cancel)."""
        t = self._txns.get(xid)
        if t is None:
            raise FunkTxnError(f"unknown txn {xid!r}")
        if t.parent is not None:
            t.parent.children.remove(t)
        self._drop_subtree(t)

    def txn_publish(self, xid):
        """Publish xid (and its ancestors); cancel competing forks
        (ref: fd_funk_txn_publish)."""
        t = self._txns.get(xid)
        if t is None:
            raise FunkTxnError(f"unknown txn {xid!r}")
        # ancestor chain, oldest first
        chain = []
        p = t
        while p is not None:
            chain.append(p)
            p = p.parent
        chain.reverse()
        # fold into a COPY, then swap the reference: concurrent readers
        # (e.g. the bank tile's RPC thread) see either the old or the
        # new published state, never a half-applied fold — publish is
        # atomic for same-process readers (the reference gets this from
        # funk's lockfree record map)
        new_root = dict(self._root)
        for txn in chain:
            for k, v in txn.recs.items():
                if v is _TOMBSTONE:
                    new_root.pop(k, None)
                else:
                    new_root[k] = v
        self._root = new_root
        # survivors: the subtree rooted at t; everything else dies
        survivors = {}

        def keep(node: _Txn):
            survivors[node.xid] = node
            for c in node.children:
                keep(c)

        for c in t.children:
            keep(c)
        for c in t.children:
            c.parent = None
        self._txns = survivors
        self.last_publish = xid

    def txn_is_prepared(self, xid) -> bool:
        return xid in self._txns

    def txn_children(self, xid) -> list:
        if xid is None:
            return [t.xid for t in self._txns.values()
                    if t.parent is None]
        return [c.xid for c in self._txns[xid].children]

    # -- records -----------------------------------------------------------

    def rec_write(self, xid, key: bytes, val):
        """Write in the given in-preparation txn (xid=None writes the
        published root directly — the genesis/snapshot-load path)."""
        if xid is None:
            self._root[key] = val
            return
        t = self._txns.get(xid)
        if t is None:
            raise FunkTxnError(f"unknown txn {xid!r}")
        t.recs[key] = val

    def rec_remove(self, xid, key: bytes):
        if xid is None:
            self._root.pop(key, None)
            return
        t = self._txns.get(xid)
        if t is None:
            raise FunkTxnError(f"unknown txn {xid!r}")
        t.recs[key] = _TOMBSTONE

    def rec_query(self, xid, key: bytes):
        """Value visible at xid: own update, else nearest ancestor's,
        else published state; None if absent/removed
        (ref: fd_funk.h fork query semantics)."""
        if xid is not None:
            t = self._txns.get(xid)
            if t is None:
                raise FunkTxnError(f"unknown txn {xid!r}")
            while t is not None:
                if key in t.recs:
                    v = t.recs[key]
                    return None if v is _TOMBSTONE else v
                t = t.parent
        return self._root.get(key)

    def root_items(self):
        return dict(self._root)

    def txn_recs(self, xid) -> dict:
        """The in-preparation txn's OWN pending writes (no ancestor
        fold; tombstones surface as None) — the bank-hash delta scan."""
        t = self._txns.get(xid)
        if t is None:
            raise FunkTxnError(f"unknown txn {xid!r}")
        return {k: (None if v is _TOMBSTONE else v)
                for k, v in t.recs.items()}

    def items_at(self, xid) -> dict:
        """All records visible at xid: the same fork-overlay visibility
        rule as rec_query, folded over the whole keyspace (nearest
        ancestor wins, tombstones hide). The stake-aggregation /
        snapshot scan entrypoint."""
        out = dict(self._root)
        chain = []
        t = self._txns.get(xid) if xid is not None else None
        while t is not None:
            chain.append(t)
            t = t.parent
        for t in reversed(chain):        # oldest ancestor first
            for k, v in t.recs.items():
                if v is _TOMBSTONE:
                    out.pop(k, None)
                else:
                    out[k] = v
        return out
