"""Transaction status cache (copy of the JAX package's svm/txncache.py;
ref: src/flamenco/runtime/fd_txncache.c).

Consensus requires that a transaction executes at most once while its
recent-blockhash is still valid (~150 slots / MAX_RECENT_BLOCKHASHES).
The status cache records every executed signature keyed by
(blockhash, signature) with the slot it executed in; a query is a hit
only if that slot is on the querying fork (ancestor set), so competing
forks each see exactly their own history — same fork discipline as funk.

root-slot registration prunes blockhashes whose newest insertion is
older than the age window, bounding memory like the reference's
fixed-footprint pools.
"""
from __future__ import annotations

MAX_CACHE_AGE_SLOTS = 150   # blockhash validity window (consensus)


class TxnCache:
    def __init__(self, max_age_slots: int = MAX_CACHE_AGE_SLOTS):
        self.max_age = max_age_slots
        # blockhash -> {signature -> [(slot, status), ...]}
        self._by_hash: dict[bytes, dict[bytes, list[tuple[int, int]]]] = {}
        # blockhash -> newest slot inserted (prune index)
        self._newest: dict[bytes, int] = {}
        self.root_slot = 0

    def insert(self, slot: int, blockhash: bytes, sig: bytes,
               status: int = 0):
        sigs = self._by_hash.setdefault(blockhash, {})
        sigs.setdefault(sig, []).append((slot, status))
        if slot > self._newest.get(blockhash, -1):
            self._newest[blockhash] = slot

    def query(self, blockhash: bytes, sig: bytes,
              ancestors) -> int | None:
        """Status if `sig` executed under `blockhash` on this fork.
        `ancestors`: container (or callable) deciding slot-on-fork;
        slots <= the root are always on every fork (published
        history)."""
        entries = self._by_hash.get(blockhash, {}).get(sig)
        if not entries:
            return None
        on_fork = ancestors if callable(ancestors) \
            else (lambda s: s in ancestors)
        for slot, status in entries:
            if slot <= self.root_slot or on_fork(slot):
                return status
        return None

    def register_root(self, root_slot: int, rooted_slots=None):
        """Advance the root. `rooted_slots`: the slots that became
        rooted history with this advance (the rooted fork's chain);
        entries recorded in (old_root, new_root] on OTHER (abandoned)
        forks are purged, so they can never shadow the rooted fork's
        view once `slot <= root` makes history globally visible
        (ref: fd_txncache root registration / purge). Passing None
        keeps every entry (single-fork callers). Blockhashes whose
        newest slot fell out of the age window are pruned wholesale."""
        old_root = self.root_slot
        self.root_slot = max(self.root_slot, root_slot)
        if rooted_slots is not None:
            on_chain = rooted_slots if callable(rooted_slots) \
                else (lambda s: s in rooted_slots)
            for sigs in self._by_hash.values():
                for sig, entries in list(sigs.items()):
                    kept = [(s, st) for s, st in entries
                            if not (old_root < s <= self.root_slot
                                    and not on_chain(s))]
                    if kept:
                        sigs[sig] = kept
                    else:
                        del sigs[sig]
        dead = [bh for bh, newest in self._newest.items()
                if newest + self.max_age < self.root_slot]
        for bh in dead:
            del self._by_hash[bh]
            del self._newest[bh]

    def __len__(self):
        return sum(len(v) for v in self._by_hash.values())
