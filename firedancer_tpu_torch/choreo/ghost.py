"""LMD-GHOST fork choice (copy of the JAX package's choreo/ghost.py;
ref: src/choreo/ghost/fd_ghost.h:1-120).

The fork tree is keyed by block id (a 32-byte hash), not slot, so
equivocating blocks for the same slot remain distinct nodes
(ref: fd_ghost.h block_id discussion). Each node carries:

  replay_stake  stake of voters whose LATEST vote is this block (LMD:
                a re-vote moves the voter's stake off the old block)
  weight        subtree sum of replay_stake (the GHOST quantity)
  valid         equivocating blocks are marked invalid for fork choice
                until duplicate-confirmed (>= 52% of stake observed
                voting for that exact block, ref: fd_ghost.h eqvoc notes)

best() is the greedy heaviest-valid traversal from the root; ties break
to the LOWER slot, matching the reference exactly
(ref: src/choreo/ghost/fd_ghost.c:135-160 — "if the weights are equal
then tie-break by lower slot number").

publish(new_root) prunes every node not descending from the new root —
the rooting-driven state pruning the tower doc calls "publishing"
(ref: src/choreo/tower/fd_tower.h rooting discussion).
"""
from __future__ import annotations

from dataclasses import dataclass, field

DUPLICATE_CONFIRMED_PCT = 0.52     # ref: fd_ghost.h ">=52%" revalidation


@dataclass
class GhostNode:
    block_id: bytes
    slot: int
    parent: bytes | None
    children: list[bytes] = field(default_factory=list)
    replay_stake: int = 0          # latest-vote stake directly on this block
    weight: int = 0                # subtree stake (self + descendants)
    valid: bool = True             # False while an unconfirmed duplicate


class Ghost:
    def __init__(self, root_block: bytes, root_slot: int, total_stake: int):
        self.total_stake = total_stake
        self.root = root_block
        self.nodes: dict[bytes, GhostNode] = {
            root_block: GhostNode(root_block, root_slot, None)}
        # voter pubkey -> (block_id, stake): the L in LMD
        self.latest: dict[bytes, tuple[bytes, int]] = {}

    # -- tree construction --------------------------------------------------

    def insert(self, block_id: bytes, slot: int, parent_block: bytes):
        if block_id in self.nodes:
            raise ValueError(f"duplicate block {block_id.hex()[:16]}")
        if parent_block not in self.nodes:
            raise KeyError(f"unknown parent {parent_block.hex()[:16]}")
        parent = self.nodes[parent_block]
        if slot <= parent.slot:
            raise ValueError(f"child slot {slot} <= parent {parent.slot}")
        self.nodes[block_id] = GhostNode(block_id, slot, parent_block)
        parent.children.append(block_id)

    # -- votes --------------------------------------------------------------

    def _bump(self, block_id: bytes, delta: int):
        n = self.nodes[block_id]
        n.replay_stake += delta
        while block_id is not None:
            node = self.nodes[block_id]
            node.weight += delta
            block_id = node.parent

    def replay_vote(self, voter: bytes, stake: int, block_id: bytes):
        """Record voter's latest vote (LMD: the previous vote's stake is
        removed first, ref: fd_ghost.h "only a validator's latest vote
        counts"). Votes for pruned/unknown blocks are ignored, matching
        the reference's vote-older-than-root drop
        (ref: fd_ghost.c:283)."""
        if block_id not in self.nodes:
            return
        prev = self.latest.get(voter)
        if prev is not None and prev[0] in self.nodes:
            self._bump(prev[0], -prev[1])
        self.latest[voter] = (block_id, stake)
        self._bump(block_id, stake)

    # -- equivocation hooks (driven by eqvoc / gossip) ----------------------

    def mark_invalid(self, block_id: bytes):
        if block_id in self.nodes:
            self.nodes[block_id].valid = False

    def mark_duplicate_confirmed(self, block_id: bytes):
        """>=52% of stake voted for exactly this version: valid again."""
        if block_id in self.nodes:
            self.nodes[block_id].valid = True

    def check_duplicate_confirmed(self, block_id: bytes) -> bool:
        n = self.nodes.get(block_id)
        if n is None:
            return False
        if n.weight >= DUPLICATE_CONFIRMED_PCT * self.total_stake:
            n.valid = True
        return n.valid

    # -- queries ------------------------------------------------------------

    def best(self) -> bytes:
        """Greedy heaviest-valid leaf-ward traversal from the root."""
        cur = self.nodes[self.root]
        while True:
            best_child = None
            for cid in cur.children:
                c = self.nodes[cid]
                if not c.valid:
                    continue
                if best_child is None:
                    best_child = c
                elif (c.weight, -c.slot) > (best_child.weight,
                                            -best_child.slot):
                    # heavier wins; equal weight -> lower slot
                    best_child = c
            if best_child is None:
                return cur.block_id
            cur = best_child

    def is_ancestor(self, a: bytes, b: bytes) -> bool:
        """a is b or an ancestor of b."""
        cur = b
        a_slot = self.nodes[a].slot
        while cur is not None:
            if cur == a:
                return True
            node = self.nodes[cur]
            if node.slot < a_slot:
                return False
            cur = node.parent
        return False

    def gca(self, a: bytes, b: bytes) -> bytes:
        """Greatest common ancestor of two blocks."""
        anc = set()
        cur = a
        while cur is not None:
            anc.add(cur)
            cur = self.nodes[cur].parent
        cur = b
        while cur is not None:
            if cur in anc:
                return cur
            cur = self.nodes[cur].parent
        raise ValueError("no common ancestor (corrupt tree)")

    def weight(self, block_id: bytes) -> int:
        return self.nodes[block_id].weight

    def path_child(self, ancestor: bytes, descendant: bytes) -> bytes:
        """The child of `ancestor` on the path down to `descendant`."""
        cur = descendant
        while True:
            p = self.nodes[cur].parent
            if p is None:
                raise ValueError("not a descendant")
            if p == ancestor:
                return cur
            cur = p

    # -- rooting ------------------------------------------------------------

    def publish(self, new_root: bytes):
        """Prune everything not descending from new_root (the tower's
        rooting-driven publish, ref: fd_tower.h)."""
        if new_root not in self.nodes:
            raise KeyError("new root unknown")
        keep: dict[bytes, GhostNode] = {}
        stack = [new_root]
        while stack:
            bid = stack.pop()
            n = self.nodes[bid]
            keep[bid] = n
            stack.extend(n.children)
        self.nodes = keep
        self.root = new_root
        self.nodes[new_root].parent = None
        self.latest = {v: (b, s) for v, (b, s) in self.latest.items()
                       if b in keep}
