"""Equivocation detection (copy of the JAX package's choreo/eqvoc.py;
ref: src/choreo/eqvoc/fd_eqvoc.h:1-60).

Equivocation is a shred producer emitting two or more versions of a
block for one slot. Detection indexes FEC-set metadata per
(slot, fec_set_idx): every shred in a FEC set signs the same merkle
root, so two shreds for the same key with different signatures (or
merkle roots) are a DIRECT proof of equivocation. An INDIRECT proof
arises when overlapping FEC-set extents imply two block layouts for the
same slot (here: a second FEC set whose index range overlaps an already
recorded one with different metadata).

The detector is bounded: state below the published root is pruned, the
same lifecycle the reference drives from tower rooting.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FecMeta:
    slot: int
    fec_set_idx: int
    merkle_root: bytes
    signature: bytes
    data_cnt: int = 0            # shreds in the set (0 = unknown)


@dataclass(frozen=True)
class EquivocationProof:
    """Two conflicting records that cannot both be honest."""
    slot: int
    a: FecMeta
    b: FecMeta
    kind: str                    # "direct" | "overlap"


class EqvocDetector:
    def __init__(self):
        # (slot, fec_set_idx) -> FecMeta (first version seen)
        self.fecs: dict[tuple[int, int], FecMeta] = {}
        # slot -> first block_id seen (block-level duplicate tracking)
        self.block_ids: dict[int, bytes] = {}

    def insert_fec(self, meta: FecMeta) -> EquivocationProof | None:
        """Record one FEC set's metadata; returns a proof on conflict.

        Direct conflict: same (slot, fec_set_idx), different merkle root
        or signature (ref: fd_eqvoc.h — "every FEC set must have the
        same signature for every shred in the set").
        Overlap conflict: a set whose [idx, idx+data_cnt) range overlaps
        a previously recorded set at a different starting index."""
        key = (meta.slot, meta.fec_set_idx)
        prev = self.fecs.get(key)
        if prev is not None:
            if (prev.merkle_root != meta.merkle_root
                    or prev.signature != meta.signature):
                return EquivocationProof(meta.slot, prev, meta, "direct")
            if not (prev.data_cnt == 0 and meta.data_cnt):
                return None
            # extent was unknown at first sight (partial FEC set): fall
            # through so the now-known data_cnt is overlap-checked and
            # recorded — otherwise an early partial insert would disable
            # overlap detection for this set forever
        # overlap scan against other sets in the same slot
        for (s, idx), other in self.fecs.items():
            if s != meta.slot or idx == meta.fec_set_idx:
                continue
            lo, hi = sorted([(idx, other.data_cnt),
                             (meta.fec_set_idx, meta.data_cnt)])
            if lo[1] and lo[0] + lo[1] > hi[0]:
                return EquivocationProof(meta.slot, other, meta, "overlap")
        self.fecs[key] = meta
        return None

    def note_block_id(self, slot: int, block_id: bytes) -> bool:
        """Track the block id per slot; True = duplicate block observed
        (two distinct ids for one slot — the caller marks both invalid
        in ghost, ref: fd_ghost.h equivocation handling)."""
        prev = self.block_ids.get(slot)
        if prev is None:
            self.block_ids[slot] = block_id
            return False
        return prev != block_id

    def prune(self, root_slot: int):
        """Drop state below the published root."""
        self.fecs = {k: v for k, v in self.fecs.items() if k[0] >= root_slot}
        self.block_ids = {s: b for s, b in self.block_ids.items()
                          if s >= root_slot}
