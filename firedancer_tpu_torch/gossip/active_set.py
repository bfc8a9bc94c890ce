"""Push active set + prune tracking (copy of the JAX package's
gossip/active_set.py; ref: src/flamenco/gossip/
fd_active_set.h, fd_prune_finder.h).

Each node pushes new CRDS values to a small rotating set of peers,
stake-weighted so high-stake nodes hear everything quickly. A peer can
PRUNE us for a given origin — "stop pushing me values from origin O" —
after seeing too many duplicates; prunes are per (peer, origin).

The prune FINDER is the mirror side: we count duplicate pushes received
per (origin, relayer) and emit prune messages for relayers responsible
for excess duplicates (the reference's fd_prune_finder min-duplicate
thresholds).
"""
from __future__ import annotations

import hashlib


class ActiveSet:
    def __init__(self, self_pubkey: bytes, size: int = 9,
                 rotate_interval_ms: int = 7_500):
        self.self_pubkey = self_pubkey
        self.size = size
        self.rotate_interval_ms = rotate_interval_ms
        self.peers: list[bytes] = []
        self.pruned: dict[bytes, set] = {}       # peer -> {origin, ...}
        self._last_rotate_ms = -1

    def maybe_rotate(self, now_ms: int, candidates: dict[bytes, int],
                     epoch: int | None = None):
        """candidates: peer pubkey -> stake. Deterministic stake-weighted
        choice per rotation epoch (sampling by seeded hash priority,
        the wsample pattern)."""
        if (self._last_rotate_ms >= 0 and
                now_ms - self._last_rotate_ms < self.rotate_interval_ms):
            return
        self._last_rotate_ms = now_ms
        epoch = epoch if epoch is not None \
            else now_ms // max(1, self.rotate_interval_ms)
        scored = []
        for pk, stake in candidates.items():
            if pk == self.self_pubkey:
                continue
            h = hashlib.sha256(
                b"active-set" + epoch.to_bytes(8, "little", signed=True)
                + self.self_pubkey + pk).digest()
            u = (int.from_bytes(h[:8], "little") + 1) / float(1 << 64)
            import math
            w = max(1, stake)
            scored.append((-math.log(u) / w, pk))
        scored.sort()
        self.peers = [pk for _, pk in scored[:self.size]]

    def push_targets(self, origin: bytes) -> list[bytes]:
        """Peers to push a value from `origin` to (prunes respected)."""
        return [p for p in self.peers
                if origin not in self.pruned.get(p, ())]

    def handle_prune(self, peer: bytes, origins: list[bytes]):
        self.pruned.setdefault(peer, set()).update(origins)


class PruneFinder:
    """Duplicate-push accounting -> prune decisions
    (ref: fd_prune_finder.h)."""

    def __init__(self, min_dups: int = 2):
        self.min_dups = min_dups
        # (origin, relayer) -> duplicate count
        self.dups: dict[tuple, int] = {}
        self.first_relayer: dict[bytes, bytes] = {}   # value hash -> relayer

    def record(self, value_hash: bytes, origin: bytes, relayer: bytes):
        """Call per received push. First relayer of a value is credited;
        later relayers of the same value accumulate duplicate counts."""
        first = self.first_relayer.get(value_hash)
        if first is None:
            self.first_relayer[value_hash] = relayer
            return
        if relayer != first:
            k = (origin, relayer)
            self.dups[k] = self.dups.get(k, 0) + 1

    def prunes_due(self) -> dict[bytes, list]:
        """relayer -> [origins] past the duplicate threshold; resets
        the counters it reports."""
        out: dict[bytes, list] = {}
        for (origin, relayer), cnt in list(self.dups.items()):
            if cnt >= self.min_dups:
                out.setdefault(relayer, []).append(origin)
                del self.dups[(origin, relayer)]
        return out
