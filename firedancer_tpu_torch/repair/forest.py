"""Forest: ancestry tree of blocks under repair + BFS frontier (copy
of the JAX package's repair/forest.py; ref: src/discof/forest/fd_forest.h:1-70 — "constructs the ancestry
tree backwards, then repairs the tree forwards (using BFS)"; per-block
shred progress via consumed/buffered/complete idx watermarks).

Shreds (turbine) and votes (gossip) announce that a slot exists; the
forest tracks, per block, which data shred indices have been buffered
and the last index (from the SLOT_COMPLETE flag), links blocks into a
parent tree (parents may be unknown for a while — orphan roots), and
answers "what's missing" in BFS order from the root so repair requests
always favor the oldest incomplete ancestry.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class ForestBlk:
    slot: int
    parent_slot: int | None = None
    idxs: set = field(default_factory=set)   # buffered data shred idxs
    complete_idx: int | None = None          # last shred idx in slot
    children: list[int] = field(default_factory=list)

    @property
    def buffered_idx(self) -> int:
        """Highest contiguous buffered idx (-1 if none)."""
        i = -1
        while i + 1 in self.idxs:
            i += 1
        return i

    @property
    def is_complete(self) -> bool:
        return (self.complete_idx is not None
                and self.buffered_idx == self.complete_idx)

    def missing(self, max_req: int = 64) -> list[int]:
        """Missing idxs up to the known end (or a probe window past the
        highest buffered when the end is unknown)."""
        end = self.complete_idx if self.complete_idx is not None \
            else (max(self.idxs) if self.idxs else 0) + 1
        out = [i for i in range(end + 1) if i not in self.idxs]
        return out[:max_req]


class Forest:
    def __init__(self, root_slot: int):
        self.root = root_slot
        self.blks: dict[int, ForestBlk] = {
            root_slot: ForestBlk(root_slot, None,
                                 complete_idx=-1)}
        self.blks[root_slot].complete_idx = -1   # root needs no repair
        self.blks[root_slot].idxs = set()

    # -- discovery ----------------------------------------------------------

    def _ensure(self, slot: int) -> ForestBlk:
        b = self.blks.get(slot)
        if b is None:
            b = self.blks[slot] = ForestBlk(slot)
        return b

    def link(self, slot: int, parent_slot: int):
        """Record ancestry (from a data shred's parent_off or a vote)."""
        if slot <= self.root:
            return
        b = self._ensure(slot)
        if b.parent_slot is None and parent_slot >= self.root:
            b.parent_slot = parent_slot
            p = self._ensure(parent_slot)
            if slot not in p.children:
                p.children.append(slot)

    def shred(self, slot: int, idx: int, parent_off: int | None = None,
              slot_complete: bool = False):
        """Register one received data shred."""
        if slot <= self.root:
            return
        b = self._ensure(slot)
        b.idxs.add(idx)
        if slot_complete:
            b.complete_idx = idx if b.complete_idx is None \
                else min(b.complete_idx, idx)
        if parent_off is not None and parent_off > 0:
            self.link(slot, slot - parent_off)

    def vote(self, slot: int):
        """A gossip vote proves the block exists (no shreds yet)."""
        if slot > self.root:
            self._ensure(slot)

    # -- repair frontier ----------------------------------------------------

    def frontier(self) -> list[int]:
        """Incomplete blocks in BFS order from the root — oldest
        ancestry first (the repair-forward order, fd_forest.h)."""
        out = []
        q = deque([self.root])
        seen = set()
        while q:
            s = q.popleft()
            if s in seen:
                continue
            seen.add(s)
            b = self.blks[s]
            if s != self.root and not b.is_complete:
                out.append(s)
            q.extend(sorted(b.children))
        # orphans (unknown parentage) repair after connected blocks
        orphans = [s for s, b in self.blks.items()
                   if s not in seen and not b.is_complete]
        return out + sorted(orphans)

    def requests(self, max_per_blk: int = 8) -> list[tuple[int, int]]:
        """(slot, shred_idx) repair requests, frontier-ordered."""
        out = []
        for s in self.frontier():
            for i in self.blks[s].missing(max_per_blk):
                out.append((s, i))
        return out

    # -- rooting ------------------------------------------------------------

    def publish(self, new_root: int):
        """Advance the root; prune everything not descending from it
        (same rooting discipline as ghost.publish)."""
        if new_root not in self.blks:
            self.blks[new_root] = ForestBlk(new_root, None,
                                            complete_idx=-1)
        keep = set()
        q = deque([new_root])
        while q:
            s = q.popleft()
            if s in keep:
                continue
            keep.add(s)
            q.extend(self.blks[s].children)
        self.blks = {s: b for s, b in self.blks.items()
                     if s in keep or (s > new_root
                                      and self.blks[s].parent_slot is None)}
        self.root = new_root
        rb = self.blks[new_root]
        rb.parent_slot = None
        rb.complete_idx = rb.complete_idx if rb.complete_idx is not None \
            else -1
        rb.idxs = set(range(rb.complete_idx + 1)) if rb.complete_idx >= 0 \
            else set()
