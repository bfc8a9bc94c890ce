"""Turbine retransmit tree: stake-weighted destination selection (copy
of the JAX package's shred/shred_dest.py),
**draw-for-draw compatible with Agave** (pinned against the
reference's fixtures in tests/test_shred_dest_agave.py).

The reference computes, per shred, a deterministic stake-weighted
shuffle of the cluster and a fanout tree over it: the leader sends to
the tree root, every node retransmits to its children (ref:
src/disco/shred/fd_shred_dest.c fd_shred_dest_compute_first /
_compute_children; weighted sampling via src/ballet/wsample).

Exact protocol (citations are into the Firedancer source tree):

- Per-shred RNG seed: sha256 of the packed 45-byte struct
  {slot u64 LE, type u8 (0xA5 data / 0x5A code), idx u32 LE,
  leader_pubkey 32B} (fd_shred_dest.c:24-31, compute_seeds).
- RNG: rand_chacha ChaCha20Rng, rolls in MODE_SHIFT — the power-of-two
  rejection zone of rand 0.8's gen_range (fd_chacha_rng.h).
- Staked nodes: weighted sampling WITHOUT replacement by cumulative-
  stake inversion over the un-removed weights in original index order
  (fd_wsample.h:8-15); the source (compute_first) or the slot leader
  (compute_children) is weight-removed BEFORE drawing.
- Unstaked nodes: uniform index draws with swap-remove
  (fd_shred_dest.c:150-190), appended after all staked positions.
- Tree addressing (fd_shred_dest.c:415-425): position 0's children
  are 1..F; position j in [1,F] sends to j+l*F for l in 1..F;
  positions > F are leaves.

The node list must order staked (stake>0) before unstaked, staked in
the consensus (stake desc, pubkey desc) order; the constructor sorts
canonically if the given order violates staked-before-unstaked.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

from ..utils.chacha import ChaChaRng

DATA_PLANE_FANOUT = 200

_EMPTY = -1              # FD_WSAMPLE_EMPTY
_INDET = -2              # FD_WSAMPLE_INDETERMINATE


@dataclass(frozen=True)
class ClusterNode:
    pubkey: bytes
    stake: int
    addr: tuple = ("", 0)          # (ip, port) the net tile sends to


class _Fenwick:
    """Prefix sums + first-index-with-cum>x search in O(log n)."""

    def __init__(self, weights):
        n = len(weights)
        self.n = n
        self.tree = [0] * (n + 1)
        for i, w in enumerate(weights):
            self._add(i, w)

    def _add(self, i, delta):
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & (-i)

    def search(self, x):
        """First index whose cumulative sum exceeds x."""
        idx = 0
        bit = 1 << self.n.bit_length()
        while bit:
            nxt = idx + bit
            if nxt <= self.n and self.tree[nxt] <= x:
                x -= self.tree[nxt]
                idx = nxt
            bit >>= 1
        return idx


class _WSample:
    """fd_wsample semantics: without-replacement cumulative inversion
    with a poisoned (excluded-stake) tail, rolls via the shared
    MODE_SHIFT rng (ref src/ballet/wsample/fd_wsample.c:720-790)."""

    def __init__(self, weights: list[int], poisoned: int = 0):
        self.weights = list(weights)
        self.live = list(weights)
        self.fen = _Fenwick(weights)
        self.unremoved = sum(weights)
        self.poisoned = poisoned
        self.poisoned_mode = False
        self.rng: ChaChaRng | None = None

    def seed(self, seed32: bytes):
        self.rng = ChaChaRng(seed32)

    def remove_idx(self, idx: int):
        w = self.live[idx]
        if w:
            self.live[idx] = 0
            self.fen._add(idx, -w)
            self.unremoved -= w

    def sample(self) -> int:
        """With-replacement draw (compute_first's per-shred root)."""
        if not self.unremoved:
            return _EMPTY
        if self.poisoned_mode:
            return _INDET
        unif = self.rng.roll_shift(self.unremoved + self.poisoned)
        if unif >= self.unremoved:
            return _INDET
        return self.fen.search(unif)

    def sample_and_remove(self) -> int:
        if not self.unremoved:
            return _EMPTY
        if self.poisoned_mode:
            return _INDET
        unif = self.rng.roll_shift(self.unremoved + self.poisoned)
        if unif >= self.unremoved:
            self.poisoned_mode = True
            return _INDET
        idx = self.fen.search(unif)
        self.remove_idx(idx)
        return idx

    def sample_and_remove_many(self, n: int) -> list[int]:
        return [self.sample_and_remove() for _ in range(n)]

    def restore_all(self):
        for i, w in enumerate(self.weights):
            if self.live[i] != w:
                self.fen._add(i, w - self.live[i])
                self.live[i] = w
        self.unremoved = sum(self.weights)
        self.poisoned_mode = False


def _seed_for(slot: int, idx: int, is_data: bool, leader: bytes) -> bytes:
    return hashlib.sha256(struct.pack(
        "<QBI", slot, 0xA5 if is_data else 0x5A, idx) + leader).digest()


def _is_data_type(shred_type: int) -> bool:
    # accepts 1/0 (tile convention), 0x80/0x40 (merkle variant types),
    # 0xA5/0x5A (legacy + seed bytes)
    return bool(shred_type & 0x80) or shred_type in (1, 0xA5)


class ShredDest:
    def __init__(self, nodes: list[ClusterNode], self_pubkey: bytes,
                 fanout: int = DATA_PLANE_FANOUT,
                 excluded_stake: int = 0):
        if fanout < 1:
            raise ValueError("fanout >= 1")
        # canonical cluster order, unconditionally: staked by
        # (stake desc, pubkey desc), then unstaked by pubkey desc —
        # every node must derive the identical tree from the same
        # cluster set regardless of list order (the reference requires
        # pre-sorted info[], fd_shred_dest.c:80-86)
        staked = sorted((n for n in nodes if n.stake > 0),
                        key=lambda n: (n.stake, n.pubkey), reverse=True)
        unstaked = sorted((n for n in nodes if n.stake <= 0),
                          key=lambda n: n.pubkey, reverse=True)
        if excluded_stake > 0 and unstaked:
            # poisoned tail implies the list holds only staked nodes
            # (fd_shred_dest.c:92-96)
            raise ValueError("excluded_stake with unstaked validators")
        self.all = staked + unstaked
        self.staked_cnt = len(staked)
        self.unstaked_cnt = len(unstaked)
        self.idx_of = {n.pubkey: i for i, n in enumerate(self.all)}
        self.self_pubkey = self_pubkey
        self.fanout = fanout
        self.excluded_stake = excluded_stake
        self.wsample = _WSample([n.stake for n in staked],
                                poisoned=excluded_stake)
        self.src_idx = self.idx_of.get(self_pubkey)
        self._unstaked_pool: list[int] = []

    # -- unstaked sampling (fd_shred_dest.c:150-226) -------------------------

    def _sample_unstaked_noprepare(self, remove_idx: int) -> int:
        lo, hi = self.staked_cnt, self.staked_cnt + self.unstaked_cnt
        removed = lo <= remove_idx < hi
        cnt = self.unstaked_cnt - (1 if removed else 0)
        if cnt == 0:
            return _EMPTY
        sample = lo + self.wsample.rng.roll_shift(cnt)
        return sample if (not removed or sample < remove_idx) \
            else sample + 1

    def _prepare_unstaked(self, remove_idx: int):
        lo, hi = self.staked_cnt, self.staked_cnt + self.unstaked_cnt
        self._unstaked_pool = [i for i in range(lo, hi)
                               if i != remove_idx]

    def _sample_unstaked(self) -> int:
        pool = self._unstaked_pool
        if not pool:
            return _EMPTY
        k = self.wsample.rng.roll_shift(len(pool))
        out = pool[k]
        pool[k] = pool[-1]
        pool.pop()
        return out

    # -- leader-side root (fd_shred_dest_compute_first) ----------------------

    def first_hop(self, slot: int, idx: int, shred_type: int,
                  leader: bytes) -> ClusterNode | None:
        """Where the LEADER (== self) sends this shred: one
        stake-weighted draw with the source removed."""
        # the reference's info[] always contains the source; ours may
        # not — count CANDIDATES (everyone but self), not list length
        if len(self.all) - (1 if self.src_idx is not None else 0) < 1:
            return None
        is_data = _is_data_type(shred_type)
        src_staked = self.src_idx is not None \
            and self.src_idx < self.staked_cnt
        if src_staked:
            self.wsample.remove_idx(self.src_idx)
        try:
            any_staked = self.staked_cnt > (1 if src_staked else 0)
            self.wsample.seed(_seed_for(slot, idx, is_data, leader))
            if any_staked:
                got = self.wsample.sample()
            else:
                got = self._sample_unstaked_noprepare(
                    self.src_idx if self.src_idx is not None else -1)
        finally:
            self.wsample.restore_all()
        return self.all[got] if got >= 0 else None

    # -- retransmitter children (fd_shred_dest_compute_children) -------------

    def children(self, slot: int, idx: int, shred_type: int,
                 leader: bytes) -> list[ClusterNode]:
        """Who WE retransmit this shred to (empty if we are a leaf,
        the leader, or unknown)."""
        out = self._children_idx(slot, idx, shred_type, leader)
        return [self.all[i] for i in out]

    def _children_idx(self, slot: int, idx: int, shred_type: int,
                      leader: bytes) -> list[int]:
        my_orig = self.src_idx
        if my_orig is None or len(self.all) - 1 < 1:
            return []
        i_am_staked = my_orig < self.staked_cnt
        lq = self.idx_of.get(leader)
        leader_is_staked = lq is not None and lq < self.staked_cnt
        leader_idx = lq if lq is not None else (1 << 63)
        if leader_idx == my_orig:
            return []          # leader uses first_hop
        if (not i_am_staked) and \
                self.staked_cnt - (1 if leader_is_staked else 0) \
                > self.fanout:
            return []          # always at the bottom of the tree
        is_data = _is_data_type(shred_type)
        fanout = self.fanout
        ws = self.wsample
        try:
            if leader_is_staked:
                ws.remove_idx(leader_idx)
            ws.seed(_seed_for(slot, idx, is_data, leader))
            my_idx = 0
            if not i_am_staked:
                if self.excluded_stake > 0:
                    return []
                shuffle = ws.sample_and_remove_many(self.staked_cnt + 1)
                my_idx = self.staked_cnt \
                    - (1 if leader_is_staked else 0)
                self._prepare_unstaked(leader_idx)
                while my_idx <= fanout:
                    s = self._sample_unstaked()
                    if s == my_orig:
                        break
                    if s == _EMPTY:
                        return []
                    my_idx += 1
            else:
                n0 = min(fanout + 1, self.staked_cnt + 1)
                shuffle = ws.sample_and_remove_many(n0)
                while my_idx <= fanout:
                    s = shuffle[my_idx]
                    if s == my_orig:
                        break
                    if s == _EMPTY:
                        return []
                    if s == _INDET:
                        my_idx = (1 << 63)
                        break
                    my_idx += 1
            if my_idx > fanout:
                return []      # leaf
            # tree addressing (fd_shred_dest.c:415-425)
            last = fanout if my_idx == 0 else my_idx + fanout * fanout
            stride = 1 if my_idx == 0 else fanout
            cursor = my_idx + 1
            stored: list[int] = []
            if last >= len(shuffle) and \
                    len(shuffle) < self.staked_cnt + 1:
                adtl = min(last + 1, self.staked_cnt + 1) - len(shuffle)
                shuffle += ws.sample_and_remove_many(adtl)
            while cursor <= min(last, self.staked_cnt):
                s = shuffle[cursor]
                if s in (_EMPTY, _INDET):
                    break
                if cursor == my_idx + stride * (len(stored) + 1):
                    stored.append(s)
                cursor += 1
            if cursor <= last and i_am_staked:
                self._prepare_unstaked(leader_idx)
            while cursor <= last:
                s = self._sample_unstaked()
                if s == _EMPTY:
                    break
                if cursor == my_idx + stride * (len(stored) + 1):
                    stored.append(s)
                cursor += 1
            return stored
        finally:
            ws.restore_all()

    # -- debugging / tests ---------------------------------------------------

    def tree_positions(self, slot: int, idx: int, shred_type: int,
                       leader: bytes) -> list[bytes]:
        """Full shuffled order with the leader removed (debug aid)."""
        is_data = _is_data_type(shred_type)
        ws = self.wsample
        lq = self.idx_of.get(leader)
        try:
            if lq is not None and lq < self.staked_cnt:
                ws.remove_idx(lq)
            ws.seed(_seed_for(slot, idx, is_data, leader))
            order = []
            while True:
                s = ws.sample_and_remove()
                if s < 0:
                    break
                order.append(s)
            self._prepare_unstaked(lq if lq is not None else -1)
            while True:
                s = self._sample_unstaked()
                if s < 0:
                    break
                order.append(s)
            return [self.all[i].pubkey for i in order]
        finally:
            ws.restore_all()
