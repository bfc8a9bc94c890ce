"""Account-conflict-aware microblock scheduler (copy of the JAX
package's pack/scheduler.py).

Semantics follow the reference's fd_pack:

* Pending transactions are priority-ordered by reward per cost unit
  (ref: src/disco/pack/fd_pack.c — treap ordered by compare_worker;
  here a lazy-deletion binary heap, which preserves the schedule order
  contract without the treap's delete-by-key machinery).
* A microblock for bank b contains only transactions that do not
  conflict with any transaction currently outstanding on OTHER banks:
  write-write and read-write overlaps are conflicts
  (ref: fd_pack.c:1760 fd_pack_schedule_impl bitset checks).
* Conflict tests use per-transaction account bitsets. The reference
  compresses into a fixed 256-bit set with reserve-on-second-reference
  (fd_pack_bitset.h:1-60) because it needs AVX-width compares; Python
  arbitrary-precision ints give exact unlimited-width bitsets for free,
  so every account gets a bit (freed when its refcount drops to zero) —
  same contract, no false negatives.
* Consensus cost limits enforced per block: total cost, per-writable-
  account write cost, vote cost, microblock count/size
  (ref: src/disco/pack/fd_pack.h:56-101 fd_pack_limits_t).

Cost/reward model (ref: src/disco/pack/fd_pack_cost.h): cost units =
per-signature + per-writable-lock + execution CUs (compute-budget
requested, else the default); reward = base fee per signature +
priority fee. Exact fee math can be swapped in without touching the
scheduler.
"""
from __future__ import annotations

import heapq
import struct
from collections import deque
from dataclasses import dataclass, field

from ..protocol.txn import ParsedTxn, parse_txn
from .cost import CostError, compute_cost

# consensus-critical defaults (cluster-agreed values; ref:
# src/disco/pack/fd_pack.h:30-36 — 48M lower bound, 12M per acct)
MAX_COST_PER_BLOCK = 48_000_000
MAX_VOTE_COST_PER_BLOCK = 36_000_000
MAX_WRITE_COST_PER_ACCT = 12_000_000

FEE_PER_SIGNATURE = 5000          # ref: fd_pack.h:20
TXN_FEE_BURN_PCT = 50             # ref: fd_pack.h:52


@dataclass
class PackLimits:
    max_cost_per_block: int = MAX_COST_PER_BLOCK
    max_vote_cost_per_block: int = MAX_VOTE_COST_PER_BLOCK
    max_write_cost_per_acct: int = MAX_WRITE_COST_PER_ACCT
    max_txn_per_microblock: int = 31
    max_microblocks_per_block: int = 16384
    # cap on serialized microblock bytes (keeps one microblock within a
    # ring frag MTU; the reference bounds block data bytes for the same
    # reason at block scale, fd_pack.h max_data_bytes_per_block)
    max_data_bytes_per_microblock: int = 1 << 20
    probe_depth: int = 64         # candidates examined per microblock


@dataclass
class TxnMeta:
    payload: bytes
    txn: ParsedTxn
    reward: int                   # lamports to the leader
    cost: int                     # cost units
    writes: tuple[bytes, ...]     # writable account keys
    reads: tuple[bytes, ...]      # readonly account keys
    is_vote: bool = False
    seq: int = 0                  # insertion order (priority tiebreak)
    w_mask: int = 0
    r_mask: int = 0


def txn_cost_and_reward(t: ParsedTxn, payload: bytes) -> tuple[int, int, bool]:
    """Full fd_pack cost/reward model -> (cost units, leader lamports,
    is_simple_vote). Raises CostError for txns the cost model rejects
    (malformed compute-budget instructions — the reference returns
    cost 0 and pack drops them, fd_pack.c:898-922)."""
    tc = compute_cost(t, payload)
    sig_rewards = FEE_PER_SIGNATURE * (t.sig_cnt + tc.precompile_sig_cnt)
    # the leader keeps the UNburned share of the signature fee
    # (fd_pack.c:914 applies the burn; burn pct fd_pack.h:52)
    reward = sig_rewards * (100 - TXN_FEE_BURN_PCT) // 100 \
        + tc.priority_fee
    return tc.total, reward, tc.is_simple_vote


def meta_from_payload(payload: bytes, seq: int = 0,
                      reward: int | None = None,
                      cost: int | None = None) -> TxnMeta:
    t = parse_txn(payload)
    if t.version == 0 and t.aluts:
        # pack's conflict bitsets require RESOLVED account sets; the
        # reference resolves v0 table loads upstream of pack (the
        # resolv tile, src/discof/resolv/). Until that tile lands in
        # the leader topology, unresolved v0 txns are refused here —
        # mis-scheduling them would break the serial-fiction invariant
        from .cost import CostError
        raise CostError("unresolved v0 address table lookups")
    keys = t.account_keys(payload)
    writes = tuple(k for i, k in enumerate(keys) if t.is_writable(i))
    reads = tuple(k for i, k in enumerate(keys) if not t.is_writable(i))
    c, r, vote = txn_cost_and_reward(t, payload)
    return TxnMeta(payload, t, reward if reward is not None else r,
                   cost if cost is not None else c, writes, reads,
                   is_vote=vote, seq=seq)


# RESOLVED frame (the resolv->pack wire, ref: src/discof/resolv/ —
# account sets, cost and reward travel WITH the payload so pack never
# re-parses and never needs account-db access for v0 txns):
#   u16 n_writes | u16 n_reads | u32 cost | u64 reward | u8 flags
#   | u16 payload_len | n_writes*32 writes | n_reads*32 reads | payload
RESOLVED_HDR = struct.Struct("<HHIQBH")
RESOLVED_FLAG_VOTE = 1


def serialize_resolved(meta: TxnMeta) -> bytes:
    """TxnMeta -> RESOLVED frame (the resolv tile's egress)."""
    flags = RESOLVED_FLAG_VOTE if meta.is_vote else 0
    return (RESOLVED_HDR.pack(len(meta.writes), len(meta.reads),
                              meta.cost, meta.reward, flags,
                              len(meta.payload))
            + b"".join(meta.writes) + b"".join(meta.reads)
            + meta.payload)


def meta_from_resolved(frame: bytes, seq: int = 0) -> TxnMeta:
    """RESOLVED frame -> TxnMeta. Account sets, cost and reward come
    off the wire verbatim — including ALUT-loaded keys a re-parse of
    the payload could NOT reproduce without db access, which is the
    whole point of the resolv tile. txn stays None: nothing downstream
    of insert reads it (microblock serialization uses the payload)."""
    nw, nr, cost, reward, flags, plen = RESOLVED_HDR.unpack_from(
        frame, 0)
    off = RESOLVED_HDR.size
    need = off + 32 * (nw + nr) + plen
    if len(frame) < need:
        raise CostError(f"short RESOLVED frame ({len(frame)} < {need})")
    writes = tuple(bytes(frame[off + 32 * i:off + 32 * (i + 1)])
                   for i in range(nw))
    off += 32 * nw
    reads = tuple(bytes(frame[off + 32 * i:off + 32 * (i + 1)])
                  for i in range(nr))
    off += 32 * nr
    payload = bytes(frame[off:off + plen])
    return TxnMeta(payload, None, reward, cost, writes, reads,
                   is_vote=bool(flags & RESOLVED_FLAG_VOTE), seq=seq)


class _AcctBits:
    """account key -> bit index, refcounted; bits freed at refcount 0
    (the reference frees at 0 too — fd_pack_bitset.h 'defer freeing the
    bit until the reference count drops to 0')."""

    def __init__(self):
        self.bits: dict[bytes, int] = {}
        self.refs: dict[bytes, int] = {}
        self.free: list[int] = []
        self.next_bit = 0

    def acquire(self, key: bytes) -> int:
        if key in self.bits:
            self.refs[key] += 1
            return self.bits[key]
        b = self.free.pop() if self.free else self.next_bit
        if b == self.next_bit:
            self.next_bit += 1
        self.bits[key] = b
        self.refs[key] = 1
        return b

    def release(self, key: bytes):
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.free.append(self.bits.pop(key))
            del self.refs[key]


class PackScheduler:
    def __init__(self, bank_cnt: int = 4, limits: PackLimits | None = None):
        self.limits = limits or PackLimits()
        self.bank_cnt = bank_cnt
        self._bits = _AcctBits()
        self._heap: list[tuple[float, int, int]] = []   # (-prio, seq, id)
        self._pending: dict[int, TxnMeta] = {}
        self._next_id = 0
        self._seq = 0
        # outstanding (in-flight) microblocks per bank: a FIFO of
        # (w_mask, r_mask, metas). The wave discipline keeps up to the
        # caller's wave depth of microblocks in flight per bank;
        # same-bank microblocks execute serially IN ORDER (the bank
        # consumes its link FIFO), so only OTHER banks' outstanding
        # masks are conflict windows — the reference's one-busy-flag
        # per bank is the wave=1 special case of this queue.
        self._out: list[deque] = [deque() for _ in range(bank_cnt)]
        # bundles: FIFO of ordered txn groups awaiting atomic placement
        # (ref: fd_pack bundle support — a bundle is never reordered,
        # never split, and outranks the regular pending pool)
        self._bundles: list[list[TxnMeta]] = []
        # block accounting
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_microblocks = 0
        self._acct_write_cost: dict[bytes, int] = {}
        self.metrics = {"inserted": 0, "scheduled": 0, "microblocks": 0,
                        "conflict_skip": 0, "limit_skip": 0,
                        "bundles": 0, "bundle_skip": 0}

    # -- insert -----------------------------------------------------------

    def insert(self, meta: TxnMeta) -> int:
        """Queue a txn; returns its pack id."""
        meta.seq = self._seq
        self._seq += 1
        meta.w_mask = 0
        meta.r_mask = 0
        for k in meta.writes:
            meta.w_mask |= 1 << self._bits.acquire(k)
        for k in meta.reads:
            meta.r_mask |= 1 << self._bits.acquire(k)
        tid = self._next_id
        self._next_id += 1
        self._pending[tid] = meta
        # reward-per-cost priority, FIFO tiebreak (deterministic)
        heapq.heappush(self._heap, (-meta.reward / max(1, meta.cost),
                                    meta.seq, tid))
        self.metrics["inserted"] += 1
        return tid

    def insert_payload(self, payload: bytes) -> int:
        return self.insert(meta_from_payload(payload))

    MAX_BUNDLE_TXNS = 5            # the reference's bundle size cap

    def insert_bundle(self, metas: list[TxnMeta]) -> int:
        """Queue an ordered atomic group (ref: fd_pack bundles — the
        Jito contract: executes in exactly this order, in one
        microblock, whole or not at all; intra-bundle account
        conflicts are expected and legal because the bank executes a
        bundle serially). Returns the bundle's queue position."""
        if not 1 <= len(metas) <= self.MAX_BUNDLE_TXNS:
            raise ValueError(f"bundle size {len(metas)}")
        # reject bundles that could NEVER schedule (limits end_block()
        # cannot relax) — otherwise the FIFO head wedges forever and
        # head-of-line-blocks every later bundle (r4 review)
        g_cost = sum(m.cost for m in metas)
        g_vote = sum(m.cost for m in metas if m.is_vote)
        g_bytes = sum(2 + len(m.payload) for m in metas)
        if g_cost > self.limits.max_cost_per_block:
            raise ValueError(f"bundle cost {g_cost} can never fit a block")
        if g_vote > self.limits.max_vote_cost_per_block:
            raise ValueError(
                f"bundle vote cost {g_vote} can never fit a block")
        if g_bytes > self.limits.max_data_bytes_per_microblock:
            raise ValueError(f"bundle bytes {g_bytes} exceed a microblock")
        g_acct: dict[bytes, int] = {}
        for m in metas:
            for k in m.writes:
                g_acct[k] = g_acct.get(k, 0) + m.cost
        for k, c in g_acct.items():
            if c > self.limits.max_write_cost_per_acct:
                raise ValueError("bundle exceeds per-account write cost")
        for meta in metas:
            meta.seq = self._seq
            self._seq += 1
            meta.w_mask = 0
            meta.r_mask = 0
            for k in meta.writes:
                meta.w_mask |= 1 << self._bits.acquire(k)
            for k in meta.reads:
                meta.r_mask |= 1 << self._bits.acquire(k)
        self._bundles.append(list(metas))
        self.metrics["inserted"] += len(metas)
        return len(self._bundles) - 1

    def _try_bundle(self, bank: int, out_w: int,
                    out_rw: int) -> list[TxnMeta] | None:
        """Oldest bundle -> its own microblock when it fits, whole or
        not at all. Conflicts are judged against OTHER banks only;
        intra-bundle overlap is the point of a bundle."""
        if not self._bundles:
            return None
        mb = self._bundles[0]
        g_w = g_r = 0
        g_cost = g_vote = 0
        g_bytes = 0
        g_acct: dict[bytes, int] = {}
        for meta in mb:
            g_w |= meta.w_mask
            g_r |= meta.r_mask
            g_cost += meta.cost
            if meta.is_vote:
                g_vote += meta.cost
            for k in meta.writes:
                g_acct[k] = g_acct.get(k, 0) + meta.cost
            g_bytes += 2 + len(meta.payload)
        if (g_w & out_rw) or (g_r & out_w):
            self.metrics["bundle_skip"] += 1
            return None
        if self.block_cost + g_cost > self.limits.max_cost_per_block \
                or self.block_vote_cost + g_vote \
                > self.limits.max_vote_cost_per_block \
                or g_bytes > self.limits.max_data_bytes_per_microblock:
            self.metrics["bundle_skip"] += 1
            return None
        for k, c in g_acct.items():
            if self._acct_write_cost.get(k, 0) + c \
                    > self.limits.max_write_cost_per_acct:
                self.metrics["bundle_skip"] += 1
                return None
        self._bundles.pop(0)
        self._out[bank].append((g_w, g_r, mb))
        self.block_cost += g_cost
        self.block_vote_cost += g_vote
        self.block_microblocks += 1
        for k, c in g_acct.items():
            self._acct_write_cost[k] = \
                self._acct_write_cost.get(k, 0) + c
        self.metrics["scheduled"] += len(mb)
        self.metrics["microblocks"] += 1
        self.metrics["bundles"] += 1
        return mb

    @property
    def pending_cnt(self) -> int:
        return len(self._pending)

    # -- schedule ---------------------------------------------------------

    def _conflicts(self, meta: TxnMeta, out_w: int, out_rw: int) -> bool:
        return bool(meta.w_mask & out_rw) or bool(meta.r_mask & out_w)

    def _block_allows(self, meta: TxnMeta, mb_cost: int,
                      mb_vote_cost: int, mb_acct_cost: dict) -> bool:
        if self.block_cost + mb_cost + meta.cost \
                > self.limits.max_cost_per_block:
            return False
        if meta.is_vote and self.block_vote_cost + mb_vote_cost \
                + meta.cost > self.limits.max_vote_cost_per_block:
            return False
        for k in meta.writes:
            if self._acct_write_cost.get(k, 0) + mb_acct_cost.get(k, 0) \
                    + meta.cost > self.limits.max_write_cost_per_acct:
                return False
        return True

    def outstanding_cnt(self, bank: int) -> int:
        """In-flight microblocks queued on `bank` (the caller's wave
        budget gate — microblock_done retires them FIFO)."""
        return len(self._out[bank])

    def schedule_microblock(self, bank: int) -> list[TxnMeta]:
        """Emit the next microblock for `bank` (empty when nothing
        schedulable). Multiple microblocks may be outstanding on one
        bank (the wave discipline); the caller signals
        microblock_done(bank) once per microblock, in FIFO order.
        (ref contract: fd_pack.c:2477 schedule_next_microblock)."""
        if self.block_microblocks >= self.limits.max_microblocks_per_block:
            return []
        out_w = 0
        out_rw = 0
        for b in range(self.bank_cnt):
            if b == bank:
                continue
            for bw, br, _ in self._out[b]:
                out_w |= bw
                out_rw |= bw | br

        # bundles outrank the pending pool and occupy a microblock
        # exclusively (never mixed, never reordered, never split)
        bundle = self._try_bundle(bank, out_w, out_rw)
        if bundle is not None:
            return bundle

        chosen: list[tuple[float, int, int]] = []
        skipped: list[tuple[float, int, int]] = []
        mb: list[TxnMeta] = []
        mb_cost = 0
        mb_vote_cost = 0
        mb_acct_cost: dict[bytes, int] = {}
        mb_bytes = 0
        mb_w = 0
        mb_r = 0
        probes = 0
        while self._heap and len(mb) < self.limits.max_txn_per_microblock \
                and probes < self.limits.probe_depth:
            entry = heapq.heappop(self._heap)
            tid = entry[2]
            meta = self._pending.get(tid)
            if meta is None:
                continue            # lazily-deleted entry
            probes += 1
            # conflicts vs other banks' outstanding AND this microblock
            if self._conflicts(meta, out_w | mb_w, out_rw | mb_w | mb_r):
                self.metrics["conflict_skip"] += 1
                skipped.append(entry)
                continue
            if not self._block_allows(meta, mb_cost, mb_vote_cost,
                                      mb_acct_cost) \
                    or mb_bytes + 2 + len(meta.payload) \
                    > self.limits.max_data_bytes_per_microblock:
                self.metrics["limit_skip"] += 1
                skipped.append(entry)
                continue
            del self._pending[tid]
            chosen.append(entry)
            mb.append(meta)
            mb_cost += meta.cost
            if meta.is_vote:
                mb_vote_cost += meta.cost
            for k in meta.writes:
                mb_acct_cost[k] = mb_acct_cost.get(k, 0) + meta.cost
            mb_bytes += 2 + len(meta.payload)
            mb_w |= meta.w_mask
            mb_r |= meta.r_mask
        for entry in skipped:       # retry later
            heapq.heappush(self._heap, entry)

        if not mb:
            return []
        self._out[bank].append((mb_w, mb_r, mb))
        self.block_cost += mb_cost
        self.block_microblocks += 1
        for m in mb:
            if m.is_vote:
                self.block_vote_cost += m.cost
            for k in m.writes:
                self._acct_write_cost[k] = \
                    self._acct_write_cost.get(k, 0) + m.cost
        self.metrics["scheduled"] += len(mb)
        self.metrics["microblocks"] += 1
        return mb

    def microblock_done(self, bank: int):
        """Bank finished executing its OLDEST outstanding microblock:
        release that microblock's account locks (banks consume their
        link FIFO, so completions arrive in schedule order; block-level
        cost accounting is permanent until end_block)."""
        if not self._out[bank]:
            return                    # idle bank: done is a no-op
        _, _, metas = self._out[bank].popleft()
        for m in metas:
            for k in m.writes:
                self._bits.release(k)
            for k in m.reads:
                self._bits.release(k)

    def end_block(self):
        """Reset per-block accounting (ref: fd_pack_end_block)."""
        self.block_cost = 0
        self.block_vote_cost = 0
        self.block_microblocks = 0
        self._acct_write_cost.clear()

    def outstanding(self, bank: int) -> list[TxnMeta]:
        """Every txn in flight on `bank`, oldest microblock first."""
        return [m for _, _, metas in self._out[bank] for m in metas]
