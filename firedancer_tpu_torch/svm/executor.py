"""Wave-scheduled block executor for system-program transfers (the port's
copy of the JAX package's svm/executor.py, with the wave scan on the card:
ops/cuda_wave.py, csrc/wave_scan.cu).

The reference replays a block by feeding a conflict DAG to N exec tiles
(ref: src/discof/replay/fd_rdisp.h:6-80, src/discof/exec/fd_exec_tile.c:
14-21, runtime entry src/flamenco/runtime/fd_runtime.h:254-266, system
program semantics src/flamenco/runtime/program/fd_system_program.c). Here
the same DAG becomes topological waves: every wave is pairwise
conflict-free, so one step of the wave-scan kernel executes the whole
wave, one thread a lane, and the kernel's loop over waves replays the
block, bit-identical to serial execution (the serial fiction), which
`execute_block_serial` pins down as the oracle.

Scope: system-program transfers. Lamports are u64, carried to and from
the kernel as (hi, lo) uint32 pairs, the reference's layout.

Failure semantics (mirrors the runtime's fee model, simplified):
  * balance < fee                -> STATUS_FEE_FAIL, no state change
  * fee <= balance < fee+amount  -> STATUS_INSUFFICIENT, fee charged
  * otherwise                    -> STATUS_OK, fee + amount moved
Transfers to unknown accounts create them (system-owned model).

Where the copy differs from the reference:
  * `WaveExecutor(device)` runs the scan on the card ("cuda", default)
    or with its plain version ("cpu"); "cuda" without a card raises;
  * `stage` packs the (W, C, 7) table into pinned host memory and copies
    it to the card with non_blocking=True; the StagedWave holds that
    pinned buffer until `finalize`, so it is never reused while the copy
    is in flight;
  * `dispatch` uploads the balances the same way, launches the kernel,
    queues the non-blocking copies of its results into pinned host
    buffers and records a CUDA event, without synchronising; `finalize`
    waits on that event;
  * shapes are still padded to power-of-two buckets per axis, as the
    reference's jit buckets are, so the two packages stage identical
    tables (the kernel needs no buckets: padding lanes are inactive).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..ops import cuda_wave
from ..ops.cuda_wave import (STATUS_FEE_FAIL, STATUS_INSUFFICIENT,
                             STATUS_OK, STATUS_PAD)
from ..replay.rdisp import ConflictDag
from .accdb import Account, commit_lamports

_MASK32 = (1 << 32) - 1


@dataclass(frozen=True)
class SystemTxn:
    """One system-program transfer: src pays fee + sends amount to dst."""
    src: bytes           # 32B pubkey
    dst: bytes           # 32B pubkey
    amount: int          # u64 lamports
    fee: int             # u64 lamports (burned in this model)


def execute_block_serial(balances: dict, txns) -> list[int]:
    """Serial oracle: execute in insertion order, mutating `balances`
    (pubkey -> int lamports). Returns per-txn status codes."""
    out = []
    for t in txns:
        bal = balances.get(t.src, 0)
        if bal < t.fee:
            out.append(STATUS_FEE_FAIL)
            continue
        if bal < t.fee + t.amount:
            balances[t.src] = bal - t.fee
            out.append(STATUS_INSUFFICIENT)
            continue
        balances[t.src] = bal - t.fee - t.amount
        balances[t.dst] = balances.get(t.dst, 0) + t.amount
        out.append(STATUS_OK)
    return out


def _build_waves(txns, key_idx):
    """Conflict DAG -> padded wave tables (numpy). Dead (padding) lanes
    point at a dummy account slot (index len(key_idx)) and are inactive,
    so they never touch a live balance."""
    dag = ConflictDag()
    for t in txns:
        dag.add_txn(writes=(t.src, t.dst), reads=())
    waves = dag.waves() if len(dag) else []
    n_waves = len(waves)
    cap = max((len(w) for w in waves), default=1)
    dummy = len(key_idx)
    src = np.full((n_waves, cap), dummy, np.int32)
    dst = np.full((n_waves, cap), dummy, np.int32)
    amt = np.zeros((n_waves, cap, 2), np.uint32)    # (hi, lo)
    fee = np.zeros((n_waves, cap, 2), np.uint32)
    tix = np.full((n_waves, cap), -1, np.int32)
    act = np.zeros((n_waves, cap), bool)
    for wi, wave in enumerate(waves):
        for li, t_idx in enumerate(wave):
            t = txns[t_idx]
            src[wi, li] = key_idx[t.src]
            dst[wi, li] = key_idx[t.dst]
            amt[wi, li] = (t.amount >> 32, t.amount & _MASK32)
            fee[wi, li] = (t.fee >> 32, t.fee & _MASK32)
            tix[wi, li] = t_idx
            act[wi, li] = True
    return waves, (src, dst, amt, fee, tix, act)


def _bucket(n: int, lo: int = 4) -> int:
    """Next power of two >= max(n, lo) (the reference's jit buckets)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def pack_table(txns, key_idx) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (packed (Wp, Cp, 7) uint32, tix (W, C), act (W, C)): the staged
    table of `txns` over the account slots of `key_idx`, exactly as the
    reference's WaveExecutor.stage packs it."""
    _, (src, dst, amt, fee, tix, act) = _build_waves(txns, key_idx)
    w, c = tix.shape
    packed = np.zeros((_bucket(w), _bucket(c), 7), np.uint32)
    packed[..., 0] = len(key_idx)
    packed[..., 1] = len(key_idx)
    packed[:w, :c, 0] = src
    packed[:w, :c, 1] = dst
    packed[:w, :c, 2:4] = amt
    packed[:w, :c, 4:6] = fee
    packed[:w, :c, 6] = act
    return packed, tix, act


def _to_device(arr: np.ndarray, dev: torch.device):
    """-> (device tensor, the pinned host tensor behind a card's copy, or
    None): a non-blocking copy from pinned memory on the card."""
    host = torch.from_numpy(arr)
    if dev.type == "cpu":
        return host, None
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(dev, non_blocking=True), pinned


@dataclass
class StagedWave:
    """One staged wave: the packed conflict table, already queued for
    the device (the transfer is balance-independent, so it is issued
    before the previous wave commits, and the host goes on while it
    runs), the pinned host buffer the copy reads, and the host-side
    decode maps. Built by WaveExecutor.stage, consumed by dispatch."""
    txns: list
    key_idx: dict
    packed_dev: object          # device tensor (or None when empty)
    pinned: object              # held until finalize
    tix: np.ndarray
    act: np.ndarray


@dataclass
class DispatchedWave:
    """An in-flight wave: the funk fork is prepared, the scan is queued
    and its results are on their way to `out` (pinned host tensors on the
    card); finalize() waits on `event` and commits."""
    staged: StagedWave
    xid: object
    prior: dict
    out: tuple                  # (bal_hi, bal_lo, statuses) host tensors
    event: object               # torch.cuda.Event, None on the CPU
    pinned: object              # the balances' upload buffer


class WaveExecutor:
    """Device-wave block execution split into stage -> dispatch ->
    finalize, so a pipelining caller (the bank tile) can stage wave k+1
    while wave k runs (on one stream, wave k+1's copy runs on the device
    after wave k's kernel; the host's staging is what overlaps):

      stage(txns)      build conflict waves, pack ALL lane tables into
                       ONE (W, C, 7) uint32 buffer, non-blocking copy to
                       the device: balance-independent, safe before the
                       previous wave committed
      dispatch(...)    prepare the funk fork, read balances (after the
                       previous wave's commit), launch the scan, queue
                       the copies back; never blocks
      finalize(...)    wait for the results, commit lamports into the
                       fork, return per-txn statuses in insertion order
    """

    def __init__(self, device="cuda"):
        self.device = resolve(device)

    def stage(self, txns) -> StagedWave:
        txns = list(txns)
        key_idx: dict = {}
        for t in txns:
            for k in (t.src, t.dst):
                if k not in key_idx:
                    key_idx[k] = len(key_idx)
        if not txns:
            return StagedWave(txns, key_idx, None, None,
                              np.zeros((0, 0), np.int32),
                              np.zeros((0, 0), bool))
        packed, tix, act = pack_table(txns, key_idx)
        dev_t, pinned = _to_device(packed, self.device)
        return StagedWave(txns, key_idx, dev_t, pinned, tix, act)

    def dispatch(self, funk, parent_xid, xid, staged: StagedWave
                 ) -> DispatchedWave:
        funk.txn_prepare(parent_xid, xid)
        if not staged.txns:
            return DispatchedWave(staged, xid, {}, None, None, None)
        n = len(staged.key_idx)
        bal = np.zeros((2, _bucket(n + 1)), np.uint32)     # (hi, lo) rows
        prior: dict = {}
        for k, i in staged.key_idx.items():
            rec = funk.rec_query(parent_xid, k)
            prior[k] = rec
            # funk values are either typed accdb Accounts or bare
            # lamports ints (legacy genesis path); both carry u64
            v = rec.lamports if isinstance(rec, Account) \
                else (0 if rec is None else int(rec))
            bal[0, i] = v >> 32
            bal[1, i] = v & _MASK32
        bal_dev, pinned = _to_device(bal, self.device)
        res = cuda_wave.wave_scan(staged.packed_dev, bal_dev[0], bal_dev[1])
        if self.device.type == "cpu":
            return DispatchedWave(staged, xid, prior, res, None, None)
        out = tuple(torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                    for r in res)
        for o, r in zip(out, res):
            o.copy_(r, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return DispatchedWave(staged, xid, prior, out, event, pinned)

    def finalize(self, funk, disp: DispatchedWave) -> list[int]:
        staged = disp.staged
        if disp.out is None:
            return []
        if disp.event is not None:
            disp.event.synchronize()
        bh, bl, st = (x.numpy() for x in disp.out)
        statuses = [STATUS_PAD] * len(staged.txns)
        tix, act = staged.tix, staged.act
        for wi, li in zip(*np.nonzero(act)):
            statuses[int(tix[wi, li])] = int(st[wi, li])
        typed = any(isinstance(v, Account) for v in disp.prior.values())
        for k, i in staged.key_idx.items():
            commit_lamports(funk, disp.xid, k,
                            (int(bh[i]) << 32) | int(bl[i]), typed,
                            disp.prior[k])
        return statuses


def execute_block(funk, parent_xid, xid, txns, device="cuda") -> list[int]:
    """Replay a block of system transfers on the device and commit the
    result as funk fork `xid` (prepared from `parent_xid`). Returns
    per-txn statuses in insertion order. One synchronous
    stage -> dispatch -> finalize round; the bank tile pipelines the
    same three calls itself.

    funk record format: key = pubkey bytes, val = int lamports.
    """
    wx = WaveExecutor(device)
    staged = wx.stage(txns)
    disp = wx.dispatch(funk, parent_xid, xid, staged)
    return wx.finalize(funk, disp)
