"""Confirmation tracking ("notar") — per-slot and per-block vote-stake
accumulation with the three Solana confirmation thresholds (copy of
the JAX package's choreo/notar.py; ref: src/choreo/notar/fd_notar.h:1-130).

Unlike ghost (which sums stake over subtrees under the LMD rule, one
fork per validator), notar counts a vote toward the voted slot/block
only, and a validator's stake may count toward multiple blocks if it
switches forks (ref header's ghost-vs-notar discussion). Votes come
from both replay and gossip; only the latest vote slot's block id is
known per vote txn, so notar keys block confirmation by block id and
slot confirmation by slot.

Thresholds (integer arithmetic, no floats — consensus math):
  * propagated           — slot-level, >= 1/3 of total stake
  * duplicate confirmed  — block-level, > 52/100 of total stake
  * optimistically conf. — block-level, >= 2/3 of total stake

When a block id reaches duplicate confirmation for a slot whose
recorded block id differs, the recorded id is replaced (the cluster
converged on the other version — ref fd_notar.h "If notar observes a
duplicate confirmation for a different block_id ... it updates").

Divergence from the reference, documented: the reference tracks voter
sets for the current and previous epoch separately (stake weights can
differ across the boundary); here one stake snapshot applies at a time
and `set_epoch_stakes` re-weights nothing retroactively. Fine for the
self-contained clusters this framework runs; flagged for interop.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SlotEntry:
    slot: int
    parent_slot: int = 0
    is_leader: bool = False
    prev_leader_slot: int | None = None
    voters: set = field(default_factory=set)
    stake: int = 0
    is_propagated: bool = False
    block_ids: set = field(default_factory=set)


@dataclass
class BlockEntry:
    block_id: bytes
    slot: int
    voters: set = field(default_factory=set)
    stake: int = 0
    dup_conf: bool = False
    opt_conf: bool = False


@dataclass(frozen=True)
class Confirmation:
    """Threshold-crossing notification for downstream consumers."""
    kind: str                   # "propagated" | "duplicate" | "optimistic"
    slot: int
    block_id: bytes | None      # None for slot-level (propagated)


class Notar:
    def __init__(self, total_stake: int = 0):
        self.total_stake = int(total_stake)
        self.stakes: dict[bytes, int] = {}
        self.slots: dict[int, SlotEntry] = {}
        self.blocks: dict[bytes, BlockEntry] = {}
        self.slot_block_id: dict[int, bytes] = {}   # our view, remappable
        self.dup_confirmed_id: dict[int, bytes] = {}
        self.root = 0

    # -- epoch / topology bookkeeping ------------------------------------

    def set_epoch_stakes(self, stakes: dict[bytes, int]):
        self.stakes = dict(stakes)
        self.total_stake = sum(self.stakes.values())

    def on_block(self, slot: int, parent_slot: int, block_id: bytes,
                 is_leader: bool = False,
                 prev_leader_slot: int | None = None):
        """Register a replayed block (our view of slot -> block id)."""
        e = self.slots.setdefault(slot, SlotEntry(slot))
        e.parent_slot = parent_slot
        e.is_leader = is_leader
        e.prev_leader_slot = prev_leader_slot
        e.block_ids.add(block_id)
        # if the cluster already dup-confirmed a version of this slot,
        # that version wins regardless of which one we replayed
        self.slot_block_id[slot] = self.dup_confirmed_id.get(
            slot, self.slot_block_id.get(slot, block_id))

    # -- vote ingest -----------------------------------------------------

    def on_vote(self, voter: bytes, slot: int,
                block_id: bytes) -> list[Confirmation]:
        """Count one (voter, slot, block_id) observation; idempotent per
        (voter, slot) at the slot level and per (voter, block) at the
        block level. Returns newly crossed thresholds."""
        if slot < self.root:
            return []
        stake = self.stakes.get(voter, 0)
        out: list[Confirmation] = []

        se = self.slots.setdefault(slot, SlotEntry(slot))
        se.block_ids.add(block_id)
        if voter not in se.voters:
            se.voters.add(voter)
            se.stake += stake
            if not se.is_propagated and 3 * se.stake >= self.total_stake \
                    and self.total_stake:
                se.is_propagated = True
                out.append(Confirmation("propagated", slot, None))

        be = self.blocks.setdefault(block_id, BlockEntry(block_id, slot))
        if voter not in be.voters:
            be.voters.add(voter)
            be.stake += stake
            if not be.dup_conf and self.total_stake \
                    and 100 * be.stake > 52 * self.total_stake:
                be.dup_conf = True
                out.append(Confirmation("duplicate", slot, block_id))
                # converge our slot -> block id view on the dup-confirmed
                # version — including for replays that arrive later
                # (on_block consults dup_confirmed_id)
                self.dup_confirmed_id[slot] = block_id
                self.slot_block_id[slot] = block_id
            if not be.opt_conf and self.total_stake \
                    and 3 * be.stake >= 2 * self.total_stake:
                be.opt_conf = True
                out.append(Confirmation("optimistic", slot, block_id))
        return out

    # -- queries ---------------------------------------------------------

    def is_propagated(self, slot: int) -> bool:
        e = self.slots.get(slot)
        return bool(e and e.is_propagated)

    def may_vote(self, slot: int) -> bool:
        """Voting rule: our previous leader block as of `slot` must have
        propagated (unless the slot is our own leader block) —
        ref fd_notar.h:19-23."""
        e = self.slots.get(slot)
        if e is None:
            return False
        if e.is_leader:
            return True
        if e.prev_leader_slot is None:
            return True
        return self.is_propagated(e.prev_leader_slot)

    def is_duplicate_confirmed(self, block_id: bytes) -> bool:
        b = self.blocks.get(block_id)
        return bool(b and b.dup_conf)

    def is_optimistically_confirmed(self, block_id: bytes) -> bool:
        b = self.blocks.get(block_id)
        return bool(b and b.opt_conf)

    # -- pruning ---------------------------------------------------------

    def publish(self, root: int):
        """Drop state below the new root (same lifecycle the reference
        drives from tower rooting)."""
        self.root = root
        dead = [s for s in self.slots if s < root]
        for s in dead:
            del self.slots[s]
            self.slot_block_id.pop(s, None)
            self.dup_confirmed_id.pop(s, None)
        dead_b = [k for k, b in self.blocks.items() if b.slot < root]
        for k in dead_b:
            del self.blocks[k]
