"""FEC payload store + slice reassembly (copy of the JAX package's
shred/store.py).

Store (ref: src/disco/store/fd_store.h:1-40): the shared map from FEC
set merkle root -> payload that decouples shred receipt from replay;
insert/query/remove plus rooting-driven publish pruning. The reference
backs it with a lock-striped wksp map; here it is the single-writer
host-side equivalent with bounded capacity and FIFO eviction.

Reasm (ref: src/discof/reasm/ — FEC sets -> ordered slices): per slot,
completed FEC sets arrive keyed by fec_set_idx (= first data shred idx)
with data_complete markers; a slice is the contiguous run of payload
from the last emitted boundary through a batch-complete set. Slices
feed the replay tile in order; the final slice of the slot carries
slot_complete.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


class FecStore:
    def __init__(self, max_sets: int = 4096):
        self.max_sets = max_sets
        # merkle_root -> (slot, fec_set_idx, payload bytes)
        self._map: OrderedDict[bytes, tuple] = OrderedDict()
        self.metrics = {"inserts": 0, "dup": 0, "evicted": 0,
                        "pruned": 0}

    def insert(self, merkle_root: bytes, slot: int, fec_set_idx: int,
               payload: bytes) -> bool:
        if merkle_root in self._map:
            self.metrics["dup"] += 1
            return False
        while len(self._map) >= self.max_sets:
            self._map.popitem(last=False)
            self.metrics["evicted"] += 1
        self._map[merkle_root] = (slot, fec_set_idx, payload)
        self.metrics["inserts"] += 1
        return True

    def query(self, merkle_root: bytes):
        v = self._map.get(merkle_root)
        return None if v is None else v[2]

    def publish(self, root_slot: int):
        """Drop sets below the consensus root (rooting-driven prune)."""
        dead = [k for k, (s, _, _) in self._map.items() if s < root_slot]
        for k in dead:
            del self._map[k]
        self.metrics["pruned"] += len(dead)

    def __len__(self):
        return len(self._map)


@dataclass
class Slice:
    slot: int
    first_fec_idx: int
    payload: bytes            # concatenated entry-batch bytes
    slot_complete: bool


class Reassembler:
    """CompletedFec stream -> ordered slices per slot."""

    def __init__(self):
        # slot -> {state}
        self._slots: dict[int, dict] = {}
        # tombstones: slots already fully emitted — a late duplicate
        # FEC set (turbine retransmit / repair race) must not rebuild
        # empty state and re-emit the same slice to replay
        self._done: set[int] = set()
        self._root = 0               # slots below never re-emit
        self.metrics = {"fecs": 0, "slices": 0, "done_slots": 0,
                        "late_dup": 0}

    def _st(self, slot: int) -> dict:
        st = self._slots.get(slot)
        if st is None:
            st = self._slots[slot] = {
                "sets": {},          # fec_set_idx -> (payload, n_shreds,
                                     #   data_complete, slot_complete)
                "next_idx": 0,       # next expected fec_set_idx
                "run_start": 0,      # first fec idx of the open slice
                "buf": [],           # payloads of the open slice
            }
        return st

    def add_fec(self, fec) -> list[Slice]:
        """fec: shred.fec_resolver.CompletedFec. Returns newly completed
        slices (possibly several when a gap fills)."""
        self.metrics["fecs"] += 1
        if fec.slot in self._done or fec.slot < self._root:
            # tombstoned, or below the published root: either way this
            # slot's slices are history and must never re-emit
            self.metrics["late_dup"] += 1
            return []
        st = self._st(fec.slot)
        payload = b"".join(fec.data_payloads)
        st["sets"][fec.fec_set_idx] = (
            payload, len(fec.data_payloads), fec.data_complete,
            fec.slot_complete)
        out = []
        # advance the contiguous frontier
        while st["next_idx"] in st["sets"]:
            pl, n, data_done, slot_done = st["sets"][st["next_idx"]]
            st["buf"].append(pl)
            st["next_idx"] += n
            if data_done or slot_done:
                out.append(Slice(fec.slot, st["run_start"],
                                 b"".join(st["buf"]), slot_done))
                self.metrics["slices"] += 1
                st["buf"] = []
                st["run_start"] = st["next_idx"]
                if slot_done:
                    self.metrics["done_slots"] += 1
                    del self._slots[fec.slot]
                    self._done.add(fec.slot)
                    return out
        return out

    def publish(self, root_slot: int):
        """Prune state below the root. Tombstones below the root can be
        dropped because the root itself now guards re-emission (the
        `slot < _root` reject in add_fec)."""
        self._root = max(self._root, root_slot)
        self._slots = {s: st for s, st in self._slots.items()
                       if s >= root_slot}
        self._done = {s for s in self._done if s >= root_slot}
