"""Hard-fork detection (copy of the JAX package's choreo/hfork.py;
ref: src/choreo/hfork/fd_hfork.h:1-80).

Consumes a stream of (vote_account, block_id, bank_hash, stake)
observations — from replayed blocks or gossip, validity of the source
block irrelevant as long as the vote is validly signed — and maintains
Map<block_id, Map<bank_hash, stake>>. A hard fork (consensus bug) is
raised when:

  * > 52% of stake agrees on a bank hash for a block id that differs
    from the hash WE computed for that block id, or
  * > 52% of stake agrees on a bank hash for a block we marked dead
    (failed to execute), or
  * our own validator identity votes a hash different from ours
    (immediate self-check, no threshold).

Per-voter state is a bounded ring of the last `max_live` votes; when a
newer vote evicts an older one, the evicted stake is subtracted — the
same heuristic bound the reference uses to keep memory finite.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass

DEAD = b"\x00" * 32             # sentinel for blocks we failed to execute


@dataclass(frozen=True)
class HardFork:
    block_id: bytes
    cluster_hash: bytes
    our_hash: bytes | None      # None = we marked the block dead
    stake: int
    total_stake: int
    reason: str                 # "divergent" | "dead" | "self"


class HforkDetector:
    def __init__(self, total_stake: int = 0, max_live: int = 32,
                 identity: bytes | None = None, max_blocks: int = 4096):
        self.total_stake = int(total_stake)
        self.max_live = int(max_live)
        self.max_blocks = int(max_blocks)
        self.identity = identity
        # block_id -> bank_hash -> stake
        self.weights: dict[bytes, dict[bytes, int]] = {}
        # voter -> ring of (block_id, bank_hash, stake)
        self.rings: dict[bytes, deque] = {}
        self.ours: OrderedDict[bytes, bytes | None] = OrderedDict()
        self.alerts: list[HardFork] = []
        self._alerted: set = set()    # (block_id, hash, reason) dedup

    def set_total_stake(self, total: int):
        self.total_stake = int(total)

    def on_our_result(self, block_id: bytes, bank_hash: bytes | None):
        """Record the hash we computed for block_id (None = marked
        dead). Re-checks any already-accumulated cluster weight. `ours`
        is an LRU capped at max_blocks — on eviction the evicted block's
        accumulated weights and alert-dedup keys go with it, so a
        permanently-resident detector stays bounded."""
        self.ours[block_id] = bank_hash
        self.ours.move_to_end(block_id)
        while len(self.ours) > self.max_blocks:
            old_bid, _ = self.ours.popitem(last=False)
            self.weights.pop(old_bid, None)
            self._alerted = {k for k in self._alerted if k[0] != old_bid}
        for h, st in self.weights.get(block_id, {}).items():
            self._check(block_id, h, st)

    def on_vote(self, voter: bytes, block_id: bytes, bank_hash: bytes,
                stake: int) -> list[HardFork]:
        """Ingest one signed vote observation. Returns alerts raised by
        this observation (also appended to self.alerts). Idempotent per
        (voter, block_id, bank_hash): the same vote arriving via both
        replay and gossip counts once."""
        before = len(self.alerts)
        ring = self.rings.setdefault(voter, deque())
        if any(e[0] == block_id and e[1] == bank_hash for e in ring):
            return []
        ring.append((block_id, bank_hash, stake))
        if len(ring) > self.max_live:
            old_bid, old_h, old_st = ring.popleft()
            per = self.weights.get(old_bid)
            if per is not None and old_h in per:
                per[old_h] -= old_st
                if per[old_h] <= 0:
                    del per[old_h]
                if not per:
                    del self.weights[old_bid]
        per = self.weights.setdefault(block_id, {})
        per[bank_hash] = per.get(bank_hash, 0) + stake

        if self.identity is not None and voter == self.identity:
            mine = self.ours.get(block_id, bank_hash)
            if mine != bank_hash:
                self._raise(block_id, bank_hash, mine, stake, "self")
        self._check(block_id, bank_hash, per[bank_hash])
        return self.alerts[before:]

    def _raise(self, block_id, bank_hash, mine, stake, reason):
        key = (block_id, bank_hash, reason)
        if key in self._alerted:
            return
        self._alerted.add(key)
        self.alerts.append(HardFork(
            block_id, bank_hash, mine, stake, self.total_stake, reason))

    def _check(self, block_id: bytes, bank_hash: bytes, stake: int):
        if not self.total_stake or 100 * stake <= 52 * self.total_stake:
            return
        if block_id not in self.ours:
            return
        mine = self.ours[block_id]
        if mine is None:
            self._raise(block_id, bank_hash, None, stake, "dead")
        elif mine != bank_hash:
            self._raise(block_id, bank_hash, mine, stake, "divergent")
