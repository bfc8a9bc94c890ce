"""Replay tile core: reassembled slices -> verified, executed blocks
-> tower notifications (copy of the JAX package's tiles/replay.py:
`normalize_replay`, and `ReplayCore`'s in-process path: `on_slice`,
`_release`, `_gauge_pending`, `_replay_slot`, `_verify_entries`,
`_execute`, the `expected` divergence verdict and the `diverge_block`
chaos seam).

The reference's replay tile (ref: src/discof/replay/fd_replay_tile.c:77-95)
consumes ordered slices from reasm, schedules their transactions
through rdisp's conflict DAG, drives exec, and publishes block
completion to tower. This core does the same over this framework's
entry-batch wire (tiles/shred.py): parse entries, re-verify the PoH
chain on `device` (ops/poh.poh_verify_entries: the SHA-256 kernel's
`poh_verify` entry on the card; the entries of a slice verify as ONE
batch), stage the txns into the ConflictDag (replay/rdisp.py), execute
wave-by-wave through the host TxnExecutor (svm/programs.py — wave
order preserves the serial fiction), fold the slot's account delta
into the bank-hash lattice on `device` (flamenco/bank_hash.py: the
BLAKE3 kernel's `lthash` entry), and emit tower block frames keyed by
the slot's bank hash.

Out-of-order slots (repair back-fill) buffer until their parent
replays: slices are per-slot complete, but execution must follow the
chain, so a repaired hole releases its buffered descendants in order.
Every replayed slot's bank hash is checked against `expected` (the
leader's per-slot hashes): a mismatch is a DIVERGENCE VERDICT — the
divergent slot lands in the metrics and the core raises, so the
supervisor flips CNC_FAIL rather than the node running on silently
with wrong state.

Where the copy differs from the reference: the PoH checks of the slots
one release runs (one slot when the replay keeps up, each slot a poll
completes when it falls behind) are one batch, where the reference
verifies a slot at a time; the verdicts are the same, and one launch
serves them all. A release runs only slots whose final slice has come
(the reference would also run a slot whose first slices are pending
when a repaired parent completes). The exec fan-out over the
exec tile family (`fanout`, the [replay] section's `exec_tile_cnt` > 0
and `redispatch_s`: ROADMAP.md queue A item 5, 5d), the snapshot
restore gate and writer (`wait_restore`, `snapshot_*`: item 5, 5f)
and with it the `crash_mid_snapshot` chaos seam are not here; the
adapter, `normalize_replay` and `Topology.tile` refuse them. A v0
transaction with address lookup tables is refused (item 15) where the
reference resolves its tables. `on_span(kind, ns)`, when given, gets
a host-clock span for each PoH check ("poh": one a release) and each
bank-hash fold ("bank_hash": one a slot with transactions).
"""
from __future__ import annotations

import difflib
import hashlib
import time

import numpy as np

from ..disco.unported import refuse
from ..flamenco.bank_hash import BankHasher, lthash_of_root
from ..funk.funk import Funk, key32
from ..ops.poh import poh_verify_entries
from ..protocol.txn import parse_txn
from ..replay.rdisp import ConflictDag
from ..runtime import CNC_RUN
from ..svm.accdb import AccDb, Account
from ..svm.programs import OK, TxnExecutor
from .shred import parse_entry_batch, parse_slice
from .tower import pack_block

# [replay] config section: its keys and defaults, as the reference's
REPLAY_DEFAULTS = {
    "exec_tile_cnt": 0,     # fan-out shards (0 = in-process execution)
    "redispatch_s": 2.0,    # fan-out wave timeout -> cancel + retry
    "verify_poh": True,
    "hashes_per_tick": 16,
}


def normalize_replay(spec) -> dict:
    """Validate + default-fill a [replay] table: raises ValueError with
    a did-you-mean on an unknown key or a bad value, and refuses the
    fan-out settings (`exec_tile_cnt` other than 0, `redispatch_s`:
    item 5)."""
    out = dict(REPLAY_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"replay spec must be a table, got {spec!r}")
    unknown = set(spec) - set(REPLAY_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        close = difflib.get_close_matches(key, sorted(REPLAY_DEFAULTS), n=1)
        raise ValueError(f"unknown replay key(s) {sorted(unknown)}"
                         + (f" (did you mean {close[0]!r}?)" if close
                            else ""))
    out.update(spec)
    out["exec_tile_cnt"] = int(out["exec_tile_cnt"])
    if out["exec_tile_cnt"] < 0:
        raise ValueError(f"replay.exec_tile_cnt must be >= 0, got "
                         f"{out['exec_tile_cnt']}")
    if out["exec_tile_cnt"]:
        refuse("[replay] exec_tile_cnt > 0 (the exec fan-out)", 5)
    if "redispatch_s" in spec:
        refuse("[replay] redispatch_s (the exec fan-out's timeout)", 5)
    out["verify_poh"] = bool(out["verify_poh"])
    out["hashes_per_tick"] = int(out["hashes_per_tick"])
    if out["hashes_per_tick"] < 1:
        raise ValueError(f"replay.hashes_per_tick must be >= 1, got "
                         f"{out['hashes_per_tick']}")
    return out


class ReplayCore:
    def __init__(self, out_ring=None, out_fseqs=None,
                 genesis: dict[bytes, int] | None = None,
                 hashes_per_tick: int = 16, verify_poh: bool = True,
                 slots_per_epoch: int = 432_000, funk=None,
                 expected: dict[int, bytes] | None = None,
                 device="cuda", cnc=None, on_span=None):
        self.funk = funk if funk is not None else Funk()
        self.cnc = cnc
        self.device = device
        self.on_span = on_span
        self.expected = dict(expected or {})
        self.db = AccDb(self.funk)
        for key, bal in (genesis or {}).items():
            self.funk.rec_write(None, key32(key),
                                Account(lamports=int(bal)))
        self.executor = TxnExecutor(self.db)
        self.out_ring = out_ring
        self.out_fseqs = out_fseqs
        self.hashes_per_tick = hashes_per_tick
        self.verify_poh = verify_poh
        # MUST match the bank tile's setting: the epoch it derives
        # flows into the Clock sysvar account, a bank-hash input
        self.slots_per_epoch = slots_per_epoch
        self.next_slot: int | None = None     # next slot to execute
        self.pending: dict[int, bytes] = {}   # received, not yet run
        self.complete: set[int] = set()       # pending with a final slice
        self.hash_of: dict[int, bytes] = {}   # slot -> final PoH hash
        self.bank_hash_of: dict[int, bytes] = {}
        # seed the accounts lattice from the boot state (the reference
        # initializes accounts_lt_hash from the snapshot)
        self.hasher = BankHasher(lthash_of_root(self.funk, device), device)
        # the diverge_block chaos seam (armed by the adapter's on_chaos)
        self._diverge_seed: int | None = None
        self.metrics = {"slices": 0, "slots_replayed": 0, "entries": 0,
                        "txns": 0, "exec_ok": 0, "exec_fail": 0,
                        "poh_fail": 0, "buffered": 0, "waves": 0,
                        "parse_fail": 0, "divergent_slot": 0,
                        "behind": 0}

    def diverge(self, seed: int):
        """Fold a rogue account into the next replayed slot's delta, so
        its bank hash is wrong: the divergence verdict must name that
        slot, never a silent wrong state."""
        self._diverge_seed = seed

    def _span(self, kind: str, t0: int):
        if self.on_span is not None:
            self.on_span(kind, time.perf_counter_ns() - t0)

    # -- slice ingest -------------------------------------------------------

    def on_slice(self, frame: bytes) -> int:
        return self.on_slices([frame])

    def on_slices(self, frames) -> int:
        """Slice frames in arrival order; the slots they complete replay
        in one release. -> slots replayed."""
        done = False
        for frame in frames:
            slot, first, fin, payload = parse_slice(frame)
            self.metrics["slices"] += 1
            # multi-slice slots accumulate (first_fec_idx orders them)
            self.pending[slot] = self.pending.get(slot, b"") + payload
            if fin:
                done = True
                self.complete.add(slot)
                if self.next_slot is None:
                    self.next_slot = slot
        return self._release() if done else 0

    def _release(self) -> int:
        # release the contiguous chain of complete slots from next_slot
        run = []
        while self.next_slot in self.complete:
            self.complete.discard(self.next_slot)
            run.append((self.next_slot, parse_entry_batch(
                self.pending.pop(self.next_slot))))
            self.next_slot += 1
        if run:
            for (slot, entries), poh_ok in zip(run, self._check_poh(run)):
                self._replay_slot(slot, entries, poh_ok)
        # slots older than the anchor (late repairs racing the anchor)
        # will never execute — drop them so pending stays bounded
        if self.next_slot is not None:
            self.pending = {s: b for s, b in self.pending.items()
                            if s >= self.next_slot}
            self.complete = {s for s in self.complete if s >= self.next_slot}
        self._gauge_pending()
        return len(run)

    def _gauge_pending(self):
        self.metrics["buffered"] = len(self.pending)
        # catch-up distance: how far the live tip has run ahead of the
        # replay cursor
        if self.pending:
            base = self.next_slot if self.next_slot is not None \
                else min(self.pending)
            self.metrics["behind"] = max(self.pending) + 1 - base
        else:
            self.metrics["behind"] = 0

    # -- per-slot replay ----------------------------------------------------

    def _check_poh(self, run) -> list:
        """PoH verdicts of a release's slots [(slot, entries)]: True or
        False for a slot whose entries chain from a known parent tip,
        None for one not checked (the first slot replayed, an empty
        slot, verify_poh off). Each slot's entries chain from the
        previous slot's tip, which the parse alone gives, so the
        entries of every checked slot verify as ONE batch."""
        prev = self.hash_of.get(run[0][0] - 1)
        chains = []
        for slot, entries in run:
            check = prev is not None and entries and self.verify_poh
            chains.append((prev, entries) if check else None)
            prev = entries[-1][1] if entries else (prev or bytes(32))
        todo = [c for c in chains if c is not None]
        if not todo:
            return [None] * len(run)
        t0 = time.perf_counter_ns()
        ok = iter(np.split(self._verify_entries(todo), np.cumsum(
            [len(e) for _, e in todo])[:-1]))
        self._span("poh", t0)
        return [None if c is None else bool(next(ok).all())
                for c in chains]

    def _replay_slot(self, slot: int, entries, poh_ok):
        self.metrics["entries"] += len(entries)
        if poh_ok is False:
            self.metrics["poh_fail"] += 1
        prev = self.hash_of.get(slot - 1)
        txns = [t for _, _, ts in entries for t in ts]
        self._slot_sigs = 0          # set per slot by _execute
        self._execute(slot, txns)
        tip = entries[-1][1] if entries else (prev or bytes(32))
        self.hash_of[slot] = tip
        # block identity = the BANK HASH (state commitment chained from
        # the parent; flamenco/bank_hash.py), not the PoH tip — forks
        # that diverge in state diverge in id (the reference's block id)
        parent_bank = self.bank_hash_of.get(slot - 1) or \
            hashlib.sha256(b"fdtpu-parent" + (slot - 1).to_bytes(
                8, "little", signed=True)).digest()
        self.bank_hash_of.setdefault(slot - 1, parent_bank)
        if self._diverge_seed is not None:
            self.hasher.apply_delta([], [(b"\xfd" * 32, Account(
                lamports=1 + self._diverge_seed % (1 << 32)))])
            self._diverge_seed = None
        bank_hash = self.hasher.bank_hash(parent_bank, self._slot_sigs,
                                          tip)
        self.bank_hash_of[slot] = bank_hash
        exp = self.expected.get(slot)
        if exp is not None and exp != bank_hash:
            # DIVERGENCE VERDICT: record the first divergent slot, then
            # fail the tile loudly
            self.metrics["divergent_slot"] = slot
            raise RuntimeError(
                f"replay divergence at slot {slot}: replayed bank hash "
                f"{bank_hash.hex()} != leader {exp.hex()}")
        if self.out_ring is not None:
            # slot 0 has no parent; tower drops the degenerate frame
            # (its tree anchors at the first real parent link anyway)
            self._publish(pack_block(slot, max(0, slot - 1), bank_hash,
                                     parent_bank), slot)
        self.metrics["slots_replayed"] += 1
        # prune old hashes (tower roots upstream; keep a window)
        if len(self.hash_of) > 1024:
            cut = slot - 512
            self.hash_of = {s: h for s, h in self.hash_of.items()
                            if s >= cut}
            self.bank_hash_of = {
                s: h for s, h in self.bank_hash_of.items() if s >= cut}

    def _publish(self, frame: bytes, slot: int):
        """Credit-gated publish; a tile that leaves RUN while
        backpressured drops the frame instead of spinning."""
        while self.out_fseqs and \
                self.out_ring.credits(self.out_fseqs) <= 0:
            if self.cnc is not None:
                self.cnc.heartbeat()
                if self.cnc.state != CNC_RUN:
                    return
            time.sleep(20e-6)
        self.out_ring.publish(frame, sig=slot)

    def _verify_entries(self, chains) -> np.ndarray:
        """[(prev tip, entries)] -> one verdict an entry, from ONE
        poh_verify_entries call on `device`: chain continuity is
        host-checked by construction (prev_i = hash_{i-1}), the hash
        work runs as one batch."""
        n = sum(len(e) for _, e in chains)
        prevs = np.empty((n, 32), np.uint8)
        mixes = np.empty((n, 32), np.uint8)
        exps = np.empty((n, 32), np.uint8)
        nums = np.empty(n, np.int32)
        has = np.empty(n, bool)
        i = 0
        for state, entries in chains:
            for num_hashes, h, ts in entries:
                prevs[i] = np.frombuffer(state, np.uint8)
                nums[i] = min(num_hashes, self.hashes_per_tick)
                mixes[i] = np.frombuffer(hashlib.sha256(
                    b"".join(t[1:65] for t in ts)).digest(), np.uint8)
                has[i] = bool(ts)
                exps[i] = np.frombuffer(h, np.uint8)
                state = h
                i += 1
        ok = poh_verify_entries(prevs, nums, mixes, has, exps,
                                max_hashes=self.hashes_per_tick,
                                device=self.device)
        return ok.cpu().numpy()

    def _execute(self, slot: int, txns: list[bytes]):
        """Stage the slot's txns into the conflict DAG and execute in
        wave order (any wave-internal order preserves the serial
        fiction; rdisp.waves() is the device-dispatch shape), then fold
        the slot's account delta into the lattice."""
        if not txns:
            return
        dag = ConflictDag()
        parsed = []
        for t in txns:
            try:
                p = parse_txn(t)
            except Exception:
                self.metrics["parse_fail"] += 1
                parsed.append(None)
                dag.add_txn((), ())
                continue
            if p.version == 0 and p.aluts:
                refuse("a v0 transaction with address lookup tables", 15)
            keys = p.account_keys(t)
            flags = [p.is_writable(i) for i in range(p.acct_cnt)]
            writes = [k for k, w in zip(keys, flags) if w]
            reads = [k for k, w in zip(keys, flags) if not w]
            parsed.append(p)
            dag.add_txn(writes, reads)
        xid = ("replay", slot)
        self.funk.txn_prepare(None, xid)
        self.executor.begin_slot(xid, slot,
                                 slots_per_epoch=self.slots_per_epoch)
        waves = dag.waves()
        self.metrics["waves"] += len(waves)
        for wave in waves:
            for i in wave:
                if parsed[i] is None:
                    continue
                r = self.executor.execute(xid, txns[i])
                self.metrics["txns"] += 1
                if r.status == OK:
                    self.metrics["exec_ok"] += 1
                else:
                    self.metrics["exec_fail"] += 1
        self._slot_sigs = sum(p.sig_cnt for p in parsed
                              if p is not None)
        # accounts-delta lattice update (BankHasher.apply_txn_delta:
        # one lthash launch a side on the device)
        t0 = time.perf_counter_ns()
        self.hasher.apply_txn_delta(self.funk, xid)
        self._span("bank_hash", t0)
        self.funk.txn_publish(xid)
