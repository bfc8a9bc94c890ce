"""Epoch leader schedule: stake-weighted rotation sampling (copy of the
JAX package's flamenco/leaders.py; ref: src/flamenco/leaders/fd_leaders.h:1-30 — rotations of
SLOTS_PER_ROTATION slots, deduped pubkey table; sampling via a
ChaCha20 RNG over cumulative stakes, ref fd_leaders.c:112 +
src/ballet/wsample/).

The schedule derives deterministically from (epoch, stake map) and is
**draw-for-draw identical to Agave's** (pinned against the reference's
mainnet epoch-454 fixtures in tests/test_leaders_agave.py):

- stakes aggregate by node identity, then sort by stake descending
  with pubkey DESCENDING tie-break (ref fd_leaders.c sort_vote_weights
  _by_stake_id: memcmp(a,b) > 0 orders first);
- the RNG is rand_chacha's ChaCha20Rng seeded with the epoch number as
  little-endian u64 in a zeroed 32-byte key (ref fd_leaders.c:112);
- each of ceil(slots/4) rotations draws Uniform<u64>[0, total_stake)
  with rand 0.7's widening-multiply rejection (MODE_MOD, ref
  fd_chacha_rng.h) and takes the first index whose cumulative stake
  exceeds the draw (WeightedIndex semantics, ref fd_wsample.h:12-15).

An explicit `seed` overrides the epoch-derived key for self-contained
cluster tests; wire-parity requires seed=None.
"""
from __future__ import annotations

import bisect

from ..utils.chacha import ChaChaRng

SLOTS_PER_ROTATION = 4          # FD_EPOCH_SLOTS_PER_ROTATION

# base58 "1111111111indeterminateLeader9QSxFYNqsXA" — the placeholder
# the reference returns for draws landing in the excluded-stake tail
# (ref fd_leaders.h FD_INDETERMINATE_LEADER)
INDETERMINATE_LEADER = bytes.fromhex(
    "00000000000000000000" "99f60f962cdd3821f30c161de30a"
    "0badf00d0badf00d")


class WeightedSampler:
    """Cumulative-stake inversion sampler (src/ballet/wsample/
    fd_wsample.h semantics, sampling WITH replacement; draw-compatible
    with rand's WeightedIndex via roll_mod). An `excluded` weight
    models the reference's poisoned tail: draws landing past the live
    cumulative range return index len(keys) (indeterminate)."""

    def __init__(self, weighted: list[tuple[bytes, int]],
                 excluded: int = 0):
        """weighted: (pubkey, stake), stake > 0; order = consensus
        order (descending stake, pubkey DESC tie-break)."""
        assert weighted, "empty stake set"
        self.keys = [k for k, _ in weighted]
        self.cum = []
        total = 0
        for _, w in weighted:
            assert w > 0
            total += w
            self.cum.append(total)
        self.total = total + excluded

    def sample_idx(self, rng: ChaChaRng) -> int:
        x = rng.roll_mod(self.total)
        return bisect.bisect_right(self.cum, x)

    def sample(self, rng: ChaChaRng) -> bytes:
        i = self.sample_idx(rng)
        return self.keys[i] if i < len(self.keys) else INDETERMINATE_LEADER


def sort_stakes(stakes: dict[bytes, int]) -> list[tuple[bytes, int]]:
    """Consensus stake order: stake descending, pubkey descending
    tie-break (ref fd_leaders.c sort_vote_weights_by_stake_id)."""
    return sorted(((k, s) for k, s in stakes.items() if s > 0),
                  key=lambda kv: (kv[1], kv[0]), reverse=True)


def epoch_seed(epoch: int) -> bytes:
    """Agave's leader-schedule RNG key: epoch as LE u64, zero-padded
    to 32 bytes (ref fd_leaders.c:112-115)."""
    return epoch.to_bytes(8, "little") + bytes(24)


class EpochLeaders:
    def __init__(self, epoch: int, seed: bytes | None,
                 stakes: dict[bytes, int], slots_per_epoch: int,
                 slots_per_rotation: int = SLOTS_PER_ROTATION,
                 excluded_stake: int = 0):
        """stakes: node identity pubkey -> active stake (zero-stake
        nodes never lead). seed=None derives Agave's epoch key; a
        bytes seed overrides it (self-contained clusters only)."""
        self.epoch = epoch
        self.slots_per_epoch = slots_per_epoch
        self.slots_per_rotation = slots_per_rotation
        self.slot0 = epoch * slots_per_epoch
        weighted = sort_stakes(stakes)
        sampler = WeightedSampler(weighted, excluded=excluded_stake)
        rng = ChaChaRng(epoch_seed(epoch) if seed is None else seed)
        n_rot = -(-slots_per_epoch // slots_per_rotation)
        # deduped pubkey table + per-rotation index, the reference's
        # space layout (fd_leaders.h "dedup pubkeys into a lookup table")
        self.pub: list[bytes] = []
        idx_of: dict[bytes, int] = {}
        self.sched: list[int] = []
        for _ in range(n_rot):
            k = sampler.sample(rng)
            i = idx_of.get(k)
            if i is None:
                i = idx_of[k] = len(self.pub)
                self.pub.append(k)
            self.sched.append(i)

    def leader_for(self, slot: int) -> bytes:
        off = slot - self.slot0
        if not 0 <= off < self.slots_per_epoch:
            raise ValueError(f"slot {slot} outside epoch {self.epoch}")
        return self.pub[self.sched[off // self.slots_per_rotation]]

    def leader_slots(self, pubkey: bytes) -> list[int]:
        """All slots this identity leads in the epoch."""
        out = []
        for r, i in enumerate(self.sched):
            if self.pub[i] == pubkey:
                base = self.slot0 + r * self.slots_per_rotation
                out.extend(
                    s for s in range(base, base + self.slots_per_rotation)
                    if s < self.slot0 + self.slots_per_epoch)
        return out
