"""Verify tile on the card: the port of firedancer_tpu/tiles/verify.py.

  in ring (txn payloads) --C++ gather--> (coalescing window)
    --> one pinned staging buffer --one H2D copy-->
    [bulk_prefilter: cuda_msm.rlc_verify_batch, the RLC batch equation
     (SHA-512 + MSM kernels), may shed an all-garbage chunk]
    --> cuda_ed.verify_batch (SHA-512 + fused verify kernels) -->
    verdicts --tcache dedup on first sig--> out ring

The host logic is the reference's, unchanged (ref:
src/disco/verify/fd_verify_tile.h:60-111): native batched parse and
dedup tags, ha-dedup queried BEFORE verify and inserted only AFTER the
signature verifies, the dispatch-time reservation that defers a
duplicate of an in-flight tag to its reserver's verdict (re-verified on
the host if the reserver failed), up to `inflight` batches in flight
over rotating staging sets, credit-gated publishing, and the `metrics`
keys. Only the device seam differs:

  * a staging set is ONE pinned uint8 host tensor (len|sig|pub|msg lanes
    back to back; the native assembler writes into its numpy view), sent
    with one non_blocking H2D copy; the lanes are split by slicing the
    device buffer;
  * the verdicts come back with a non_blocking D2H copy, and a CUDA event
    recorded after it stands for the batch: `event.query()` is the
    readiness test, `event.synchronize()` the blocking wait. A staging
    set is not reused until its event has completed.

Coalescing (`coalesce_us` > 0, the reference's tiles/verify.py:243-251,
671-716): sub-full gathers are held until one chunk's lane budget
fills, the window deadline passes, or ingest idles with no batch in
flight; a full gather with nothing held dispatches directly.

Bulk RLC pre-filter (`mode="bulk_prefilter"`, the reference's
tiles/verify.py:439-518, 801-814; the flood front door): a full chunk,
or any chunk while the ingest-saturation window is open, is first gated
by one random-linear-combination batch equation with a secret per-chunk
z. It runs on the staging set's device buffer from the one H2D copy,
which the strict dispatch then reuses; lanes outside the tested range
carry z = 0. A chunk that fails while ingest is saturated is bisected,
and only when both halves fail too (an all-garbage chunk) is it shed
without a strict dispatch; any other chunk goes to the strict kernels,
which stay the only accept authority (the RLC equation is cofactored).
The boot warmup of the RLC path raises on failure: there is no silent
switch to strict mode.

Device faults (the reference's tiles/verify.py:417-610, 849-960): a
dispatch is retried `device_retries` times (a chaos plan's
`fail_dispatch` fails attempts on purpose, utils/chaos.py), and with
`device_timeout_s` set the verdict wait spins on `Event.query()` up to
that deadline, heartbeating every 256 spins, instead of blocking in
`synchronize()`. A dispatch that fails every retry, a lost readback or a
wait past its deadline raises out of `poll_once`: the stem marks the
tile FAIL and the supervisor's policy applies (a restart boots a new
process, whose warmup builds and launches the kernels again). The port
has no CPU path on the card's behalf: the reference's degradation to
utils/ed25519_ref (`device_fail_limit`, `_degrade`, :849-960) is
refused (disco/unported.py), and so the `cpu_fallback` gauge stays 0.
The boot warmup raises too: a kernel that does not build, load or
launch makes the constructor fail.

With a trace writer (`trace`) the tile records its ingest (EV_CONSUME)
and publish (EV_PUBLISH) lineage, each dispatch (EV_TPU_DISPATCH: the
launch) and readback (EV_TPU_READBACK: the event wait), and credit
stalls (EV_BACKPRESSURE).

Out of scope in this slice: devices > 1 (ROADMAP.md queue A item 7).
"""
from __future__ import annotations

import ctypes as ct
import os
import time
from collections import deque

import numpy as np
import torch

from .. import device as _device
from ..disco.metrics import HistAccum
from ..ops import cuda_ed, cuda_msm
from ..protocol.txn import MTU
from ..runtime import CNC_RUN, Ring, Tcache
from ..runtime.tango import lib as _lib
from ..trace import chaos_event
from ..trace import events as trace_ev
from ..utils.chaos import ChaosDeviceError, ChaosPlan
from ..utils.tempo import monotonic_ns

_u8p = ct.POINTER(ct.c_uint8)
_i32p = ct.POINTER(ct.c_int32)
_u32p = ct.POINTER(ct.c_uint32)
_u64p = ct.POINTER(ct.c_uint64)

_ROADMAP = "ROADMAP.md queue A"


def parse_batch(buf: np.ndarray, sizes: np.ndarray, seed: bytes):
    """Native batched txn parse + seeded dedup-tag hash.

    buf (n, stride) uint8, sizes (n,) uint32 -> (meta (n,8) int32,
    tags (n,) uint64). meta[:,0] is the parse-ok flag; layout per
    native/fdtpu.h::fdtpu_txn_parse_batch."""
    n, stride = buf.shape
    buf = np.ascontiguousarray(buf)
    sizes = np.ascontiguousarray(sizes, np.uint32)
    meta = np.zeros((n, 8), np.int32)
    tags = np.zeros((n,), np.uint64)
    s0 = int.from_bytes(seed[:8], "little")
    s1 = int.from_bytes(seed[8:16], "little")
    _lib.fdtpu_txn_parse_batch(
        buf.ctypes.data_as(_u8p), sizes.ctypes.data_as(_u32p), n, stride,
        s0, s1, meta.ctypes.data_as(_i32p), tags.ctypes.data_as(_u64p))
    return meta, tags


class _StageBuf:
    """One rotating staging set: a single pinned host tensor whose lane
    regions (len|sig|pub|msg) are numpy views the native assembler fills
    in place, its device twin, and the verdict readback buffer. `txn`
    (lane -> txn row map) is host-only bookkeeping."""

    __slots__ = ("host", "flat", "ln", "sig", "pub", "msg", "txn", "dev",
                 "ok_host")

    def __init__(self, batch: int, max_len: int, dev: torch.device):
        size = batch * (4 + 64 + 32 + max_len)
        pin = dev.type == "cuda"
        self.host = torch.zeros(size, dtype=torch.uint8, pin_memory=pin)
        self.flat = self.host.numpy()
        o = 4 * batch                      # int32 lens first: 4B-aligned
        self.ln = self.flat[:o].view(np.int32)
        self.sig = self.flat[o:o + 64 * batch].reshape(batch, 64)
        o += 64 * batch
        self.pub = self.flat[o:o + 32 * batch].reshape(batch, 32)
        o += 32 * batch
        self.msg = self.flat[o:].reshape(batch, max_len)
        self.txn = np.zeros(batch, np.int32)
        self.dev = torch.empty(size, dtype=torch.uint8, device=dev)
        self.ok_host = torch.zeros(batch, dtype=torch.bool, pin_memory=pin)


class _Verdicts:
    """An in-flight batch: its staging set and the event recorded after
    the verdicts' D2H copy (None on the CPU, where the copy is done)."""

    __slots__ = ("bs", "event")

    def __init__(self, bs: _StageBuf, event):
        self.bs, self.event = bs, event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.bs.ok_host.numpy().copy()


class _Shed:
    """A chunk the prefilter shed: every lane failed, nothing in flight."""

    __slots__ = ("ok",)
    event = None

    def __init__(self, batch: int):
        self.ok = np.zeros(batch, bool)

    def ready(self) -> bool:
        return True

    def result(self) -> np.ndarray:
        return self.ok


class VerifyTile:
    def __init__(self, in_ring: Ring, out_ring: Ring, tcache: Tcache,
                 batch: int = 256, max_len: int = MTU, out_fseqs=None,
                 dedup_seed: bytes | None = None,
                 rr_cnt: int = 1, rr_idx: int = 0, devices: int = 1,
                 device_retries: int = 2,
                 device_timeout_s: float | None = None,
                 chaos: dict | None = None,
                 trace=None, trace_link: int = 0, trace_link_in: int = 0,
                 coalesce_us: float = 0.0, mode: str = "strict",
                 prefilter_shed: bool = True, device="cuda"):
        if mode not in ("strict", "bulk_prefilter"):
            raise ValueError(f"unknown verify mode {mode!r} "
                             f"(strict | bulk_prefilter)")
        if int(devices) > 1:
            raise NotImplementedError(f"devices > 1 is {_ROADMAP} item 7 "
                                      f"(multi-GPU)")
        self.dev = _device.resolve(device)
        self.mode = mode
        # False: the prefilter counts but never sheds (every chunk goes
        # to strict); the fdtune bulk_prefilter knob steers it at run
        # time (disco/tiles.py VerifyAdapter.housekeeping)
        self.prefilter_shed = bool(prefilter_shed)
        self.in_ring, self.out_ring, self.tcache = in_ring, out_ring, tcache
        # horizontal sharding: tile rr_idx owns frags with
        # seq % rr_cnt == rr_idx (ref: src/disco/verify/fd_verify_tile.c)
        if not 0 <= rr_idx < rr_cnt:
            raise ValueError(f"rr_idx {rr_idx} out of range {rr_cnt}")
        self.rr_cnt, self.rr_idx = rr_cnt, rr_idx
        # a txn's sig lanes never split across device chunks, so a chunk
        # must hold the max per-txn signature count (SIG_MAX = 12)
        if batch < 12:
            raise ValueError(f"verify batch {batch} < max sig_cnt 12")
        self.batch, self.max_len = batch, max_len
        self.out_fseqs = list(out_fseqs or [])
        # per-boot random seed: tags are unpredictable to senders
        self.dedup_seed = dedup_seed if dedup_seed is not None \
            else os.urandom(16)
        self.seq = 0
        self._cnc = None
        self.metrics = {
            "rx": 0, "parse_fail": 0, "dedup_drop": 0, "verify_fail": 0,
            "tx": 0, "overruns": 0, "batches": 0, "backpressure": 0,
            "device_errors": 0, "cpu_fallback": 0,
            "rlc_batches": 0, "rlc_pass": 0, "rlc_lanes": 0,
            "rlc_shed": 0, "rlc_ns": 0,
        }
        # duplicates inside the async pipeline window are deferred and
        # decided by the reserving txn's verdict; the window is the
        # pending records' `reserved` tag arrays
        self._deferred: dict[int, list[bytes]] = {}
        self._deferred_n = 0
        self._deferred_cap = 256          # bounds attacker-driven parking
        # per-tile secret RLC coefficient stream: the batch equation's
        # soundness rests on z being unpredictable to txn senders (tests
        # rig _draw_z to reach the torsion class)
        self._rlc_rng = np.random.default_rng(
            int.from_bytes(os.urandom(16), "little"))
        # ingest-saturation clock: a full gather opens the window inside
        # which the prefilter may shed all-garbage chunks
        self._hot_until = 0
        self._hot_hold_ns = 100_000_000
        # coalescing window (0: every gather dispatches as it is)
        self._coalesce_ns = max(0, int(float(coalesce_us) * 1e3))
        self._hold_buf = np.zeros((batch, max_len), np.uint8) \
            if self._coalesce_ns else None
        self._hold_sizes = np.zeros(batch, np.uint32)
        self._hold_n = 0
        self._hold_deadline = 0
        # device faults: bounded retry and an optional verdict deadline;
        # past them the failure raises
        self.device_retries = max(0, int(device_retries))
        self.device_timeout_s = device_timeout_s
        self._chaos = ChaosPlan(chaos) if chaos else None
        # flight recorder (None: untraced, one attribute check a hook)
        self._trace = trace
        self._trace_link = trace_link
        self._trace_link_in = trace_link_in
        # device-attributed time: dispatch + readback, per batch
        self.tpu_hist = HistAccum()
        self.inflight = max(1, int(os.environ.get(
            "FDTPU_VERIFY_INFLIGHT", "2")))
        self._bufsets = [_StageBuf(batch, max_len, self.dev)
                         for _ in range(self.inflight + 1)]
        self._bufset_fut = [None] * (self.inflight + 1)
        self._disp = 0
        self._pending: deque = deque()
        # warm up before the tile runs: the first dispatch builds the
        # kernels (nvcc) and loads them, which must not stall poll_once
        warmup_t0 = monotonic_ns()
        self._device_verify(self._bufsets[0]).result()
        if mode == "bulk_prefilter":
            # the RLC path builds and runs once too (on the buffer the
            # strict warmup uploaded), and raises here if it cannot: the
            # prefilter never turns itself off
            self._rlc_ok(self._bufsets[0], 0, min(2, batch))
        self.compile_ns = monotonic_ns() - warmup_t0

    def _upload(self, bs: _StageBuf):
        """The one H2D copy of the whole staging set."""
        bs.dev.copy_(bs.host, non_blocking=True)

    def _lanes(self, bs: _StageBuf):
        """(sig, pub, msg, msg_len) views of the staging set's device
        buffer."""
        b, mlen = self.batch, self.max_len
        dev = bs.dev
        o_sig, o_pub = 4 * b, (4 + 64) * b
        o_msg = o_pub + 32 * b
        return (dev[o_sig:o_pub].view(b, 64), dev[o_pub:o_msg].view(b, 32),
                dev[o_msg:].view(b, mlen),
                dev[:o_sig].view(torch.int32))   # little-endian int32

    def _device_verify(self, bs: _StageBuf,
                       uploaded: bool = False) -> _Verdicts:
        """The H2D copy (unless the prefilter made it), the kernels, the
        verdicts' D2H copy and an event after it. Never waits; the
        staging set stays untouched until the event completes (the
        _bufset_fut guard)."""
        if not uploaded:
            self._upload(bs)
        ok = cuda_ed.verify_batch(*self._lanes(bs), device=self.dev)
        bs.ok_host.copy_(ok, non_blocking=True)
        event = None
        if self.dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Verdicts(bs, event)

    def _dispatch(self, bs: _StageBuf, lanes: int, uploaded: bool):
        """Guarded device dispatch: chaos injection and bounded retry.
        -> a _Verdicts in flight; raises when every attempt failed."""
        for _ in range(self.device_retries + 1):
            try:
                if self._chaos is not None and \
                        self._chaos.take_dispatch_failure():
                    chaos_event(self._trace, "fail_dispatch")
                    raise ChaosDeviceError("injected dispatch failure")
                t0 = monotonic_ns()
                fut = self._device_verify(bs, uploaded)
                self.tpu_hist.add(monotonic_ns() - t0)
                if self._trace is not None:
                    self._trace.span(trace_ev.EV_TPU_DISPATCH, t0,
                                     count=lanes)
                return fut
            except Exception as e:
                self.metrics["device_errors"] += 1
                err = e
        raise RuntimeError(f"verify: dispatch failed "
                           f"{self.device_retries + 1} times") from err

    def _read_verdicts(self, fut) -> np.ndarray:
        """A chunk's verdicts, waited for up to device_timeout_s when set
        (spinning on Event.query, never synchronize)."""
        if not self.device_timeout_s or fut.event is None:
            return fut.result()
        deadline = time.perf_counter() + self.device_timeout_s
        spins = 0
        while not fut.event.query():
            if time.perf_counter() >= deadline:
                # the wedged-device signature
                self.metrics["device_errors"] += 1
                raise TimeoutError(f"verdicts not ready after "
                                   f"{self.device_timeout_s} s")
            spins += 1
            if spins % 256 == 0 and self._cnc is not None:
                self._cnc.heartbeat()
            time.sleep(0.0005)
        return fut.result()

    def _draw_z(self, n: int) -> np.ndarray:
        """Secret per-chunk RLC coefficients (n, 16) uint8."""
        return self._rlc_rng.integers(0, 256, (n, 16), dtype=np.uint8)

    def _rlc_ok(self, bs: _StageBuf, start: int, stop: int) -> bool:
        """One cofactored RLC batch equation over the uploaded lanes
        [start, stop) of the staging set. Every other lane carries z = 0,
        an identity contribution whatever its stale bytes decode to.

        Lanes failing the structural prechecks are masked out of the sum,
        so a range whose every lane is structural garbage passes
        vacuously: that counts as a failure here (nothing survived the
        prechecks), while a mixed range keeps its masked pass."""
        z = np.zeros((self.batch, 16), np.uint8)
        z[start:stop] = self._draw_z(stop - start)
        ok, pre = cuda_msm.rlc_verify_batch(*self._lanes(bs), z,
                                            device=self.dev)
        return bool(ok) and bool(pre[start:stop].any())

    def _rlc_prefilter(self, bs: _StageBuf, lanes: int) -> bool:
        """The flood front door, before the strict dispatch. False only
        when the chunk is to be SHED: the equation failed (the caller
        attested saturation: a full chunk, or the hot window open) and
        both bisection halves failed too. A mixed chunk (either half
        clean) always goes to the strict kernels."""
        t0 = monotonic_ns()
        self.metrics["rlc_batches"] += 1
        self.metrics["rlc_lanes"] += lanes
        keep = True
        if self._rlc_ok(bs, 0, lanes):
            self.metrics["rlc_pass"] += 1
        elif self.prefilter_shed and lanes >= 2:
            h = lanes // 2
            self.metrics["rlc_batches"] += 2
            keep = self._rlc_ok(bs, 0, h) or self._rlc_ok(bs, h, lanes)
        self.metrics["rlc_ns"] += monotonic_ns() - t0
        return keep

    def poll_once(self) -> int:
        """Gather -> parse -> ha-dedup -> async device verify -> (queue)
        -> publish. Returns the number of frags consumed (0 only when
        the ring was idle)."""
        self._drain(block=False)
        want = self.batch - self._hold_n
        n, self.seq, buf, sizes, sigs, ovr, seqs = self.in_ring.gather(
            self.seq, want, self.max_len, want_seqs=True)
        self.metrics["overruns"] += ovr
        if self.mode != "strict" and (n >= want or ovr):
            # ingest outpaces the tile: open (or refresh) the window in
            # which the prefilter may shed
            self._hot_until = monotonic_ns() + self._hot_hold_ns
        if not n:
            # idle ingest: a held window dispatches unless batches are in
            # flight and its deadline is ahead; in-flight batches always
            # retire
            if self._hold_n and (not self._pending or
                                 monotonic_ns() >= self._hold_deadline):
                self._flush_hold()
            if self._pending:
                self._drain(block=True)
            return 0
        consumed = n
        mine = None
        if self.rr_cnt > 1:
            mine = (seqs[:n] % self.rr_cnt) == self.rr_idx
            buf, sizes = buf[:n][mine], sizes[:n][mine]
            n = int(mine.sum())
            if not n:
                return consumed
        else:
            buf, sizes = buf[:n], sizes[:n]
        self.metrics["rx"] += n
        if self._trace is not None:
            # ingest lineage: the upstream producer's sigs
            self._trace.frag_batch(
                trace_ev.EV_CONSUME,
                sigs[:consumed] if mine is None else sigs[:consumed][mine],
                link=self._trace_link_in)
        if not self._coalesce_ns or (not self._hold_n and n >= self.batch):
            # no window, or a full gather with nothing held: dispatch the
            # gather buffer as it is
            self._process_batch(buf, sizes, n)
            return consumed
        if not self._hold_n:
            self._hold_deadline = monotonic_ns() + self._coalesce_ns
        self._hold_buf[self._hold_n:self._hold_n + n] = buf
        self._hold_sizes[self._hold_n:self._hold_n + n] = sizes
        self._hold_n += n
        if self._hold_n >= self.batch or \
                monotonic_ns() >= self._hold_deadline:
            self._flush_hold()
        return consumed

    def _flush_hold(self):
        """Dispatch the held window; the record keeps its own copy, since
        the hold buffer is reused."""
        n, self._hold_n = self._hold_n, 0
        self._process_batch(self._hold_buf[:n].copy(),
                            self._hold_sizes[:n].copy(), n)

    def set_coalesce_ns(self, ns: int):
        """Steer the coalescing window at run time. Narrowing to 0 flushes
        what is held; widening from 0 allocates the hold buffer."""
        ns = max(0, int(ns))
        if ns == self._coalesce_ns:
            return
        if ns == 0 and self._hold_n:
            self._flush_hold()
        if ns and self._hold_buf is None:
            self._hold_buf = np.zeros((self.batch, self.max_len), np.uint8)
        self._coalesce_ns = ns

    def _process_batch(self, buf, sizes, n: int):
        """Parse -> tag -> ha-dedup + batched in-flight reservation ->
        fixed-shape device chunks, dispatched async."""
        buf = np.ascontiguousarray(buf[:n])
        sizes = np.ascontiguousarray(sizes[:n], np.uint32)
        meta, tags = parse_batch(buf, sizes, self.dedup_seed)
        ok = meta[:, 0] != 0
        self.metrics["parse_fail"] += int(n - ok.sum())

        hit = self.tcache.query_batch(tags, mask=ok.astype(np.uint8))
        dup_pre = ok & (hit != 0)
        self.metrics["dedup_drop"] += int(dup_pre.sum())
        cand_idx = np.nonzero(ok & ~dup_pre)[0]
        reserved = np.zeros(0, np.uint64)
        if cand_idx.size:
            ctags = tags[cand_idx]
            window = [r["reserved"] for r in self._pending
                      if len(r["reserved"])]
            infl = np.isin(ctags, np.concatenate(window)) if window \
                else np.zeros(len(ctags), bool)
            first = np.zeros(len(ctags), bool)
            first[np.unique(ctags, return_index=True)[1]] = True
            res_m = first & ~infl
            reserved = ctags[res_m]
            defer = cand_idx[~res_m]
            if defer.size:
                dup_pre[defer] = True    # twins still in flight: defer
                for i in defer:
                    if self._deferred_n < self._deferred_cap:
                        self._deferred.setdefault(int(tags[i]), []) \
                            .append(bytes(buf[i, :sizes[i]]))
                        self._deferred_n += 1
                    else:
                        self.metrics["dedup_drop"] += 1  # pool overflow
        skip = np.ascontiguousarray(~ok | dup_pre).astype(np.uint8)
        cand = ok & ~dup_pre
        if not cand.any():
            return

        # FAIL-CLOSED: a candidate txn counts as verified only if every
        # one of its signature lanes ran on the device AND passed
        chunks = []
        cursor = ct.c_int64(0)
        while cursor.value < n:
            k = self._disp % len(self._bufsets)
            if self._bufset_fut[k] is not None:
                # this staging set still feeds an in-flight batch
                self._read_verdicts(self._bufset_fut[k])
                self._bufset_fut[k] = None
            bs = self._bufsets[k]
            lanes = _lib.fdtpu_verify_assemble(
                buf.ctypes.data_as(_u8p),
                sizes.ctypes.data_as(_u32p),
                meta.ctypes.data_as(_i32p), skip.ctypes.data_as(_u8p),
                n, buf.shape[1], ct.byref(cursor), self.batch,
                self.max_len,
                bs.sig.ctypes.data_as(_u8p),
                bs.pub.ctypes.data_as(_u8p),
                bs.msg.ctypes.data_as(_u8p),
                bs.ln.ctypes.data_as(_i32p),
                bs.txn.ctypes.data_as(_i32p))
            if not lanes:
                break
            uploaded = False
            if self.mode == "bulk_prefilter" and (
                    lanes >= self.batch or monotonic_ns() < self._hot_until):
                self._upload(bs)
                uploaded = True
                if not self._rlc_prefilter(bs, lanes):
                    # an all-garbage chunk under saturation: shed at MSM
                    # cost, every lane failed, no strict dispatch (the
                    # staging set is free again)
                    self.metrics["rlc_shed"] += lanes
                    chunks.append((_Shed(self.batch), bs.txn[:lanes].copy()))
                    continue
            fut = self._dispatch(bs, lanes, uploaded)
            self._bufset_fut[k] = fut
            self._disp += 1
            self.metrics["batches"] += 1
            chunks.append((fut, bs.txn[:lanes].copy()))
        self._pending.append(
            {"chunks": chunks, "buf": buf, "sizes": sizes,
             "tags": tags, "cand": cand, "n": n, "reserved": reserved})
        while len(self._pending) > self.inflight:
            self._drain(block=True, max_sets=1)

    def _drain(self, block: bool, max_sets: int | None = None):
        """Retire pending device batches: oldest-first, stopping at the
        first unresolved one when block=False."""
        done = 0
        while self._pending and (max_sets is None or done < max_sets):
            rec = self._pending[0]
            if not block and not all(f.ready() for f, _ in rec["chunks"]):
                return
            self._pending.popleft()
            self._finalize(rec)
            done += 1

    def _host_verify_payload(self, p: bytes) -> bool:
        """Reference-path verdict for ONE raw txn payload, with the same
        fail-closed rules as the device lane assembler (the deferred-
        duplicate slow path)."""
        from ..protocol.txn import parse_txn
        from ..utils.ed25519_ref import verify as _ref_verify
        try:
            t = parse_txn(p)
        except Exception:
            return False
        msg = t.message(p)
        if len(msg) > self.max_len:
            return False                 # assembler drops over-MTU too
        return all(_ref_verify(sig, pub, msg)
                   for sig, pub in zip(t.signatures(p),
                                       t.signer_pubkeys(p)))

    def _finalize(self, rec):
        """Read back verdicts and batch-publish one record (tags were
        already reserved at dispatch)."""
        n, cand = rec["n"], rec["cand"]
        txn_ok = cand.copy()
        covered = np.zeros(n, bool)
        rb_t0 = monotonic_ns()
        try:
            for fut, live in rec["chunks"]:
                lane_ok = self._read_verdicts(fut)
                covered[live] = True
                # a txn passes only if ALL its signature lanes verified
                failed = live[~lane_ok[:len(live)]]
                txn_ok[failed] = False
        except Exception:
            # lost verdicts: the tile fails
            self.metrics["device_errors"] += 1
            raise
        finally:
            if rec["chunks"]:
                self.tpu_hist.add(monotonic_ns() - rb_t0)
                if self._trace is not None:
                    self._trace.span(trace_ev.EV_TPU_READBACK, rb_t0,
                                     count=len(rec["chunks"]))
        txn_ok &= covered
        self.metrics["verify_fail"] += int((cand & ~txn_ok).sum())

        # tcache insert only for txns whose signatures VERIFIED; a racing
        # duplicate between query and insert is dropped here
        dup_post = self.tcache.insert_batch(rec["tags"],
                                            mask=txn_ok.astype(np.uint8))
        late = txn_ok & (dup_post != 0)
        self.metrics["dedup_drop"] += int(late.sum())
        txn_ok &= dup_post == 0
        self._resolve_deferred(rec["reserved"])

        mask = txn_ok.astype(np.uint8)
        start, fwd = 0, 0
        while True:
            # lineage stamps are taken before the frags become visible
            pub_ts = monotonic_ns() if self._trace is not None else 0
            stop, pub = self.out_ring.publish_batch(
                rec["buf"], rec["sizes"], rec["tags"], mask,
                fseqs=self.out_fseqs, start=start)
            fwd += pub
            if self._trace is not None and pub:
                # lineage: the dedup tags the downstream consumes carry
                self._trace.frag_batch(
                    trace_ev.EV_PUBLISH,
                    rec["tags"][start:stop][mask[start:stop] != 0],
                    link=self._trace_link, ts_ns=pub_ts)
            start = stop
            if start >= n:
                break
            if not self._wait_credits():
                break               # halted while backpressured
        self.metrics["tx"] += fwd

    def _resolve_deferred(self, released_tags):
        """Decide duplicates parked while their tag was in flight: the
        reserver PASSED (tag now in the tcache) -> true duplicates,
        dropped; the reserver FAILED -> each parked copy is re-verified
        on the host and forwarded if genuine."""
        hb = 0
        for t in np.asarray(released_tags, np.uint64).tolist():
            for p in self._deferred.pop(t, ()):
                if hb % 8 == 0 and self._cnc is not None:
                    self._cnc.heartbeat()
                hb += 1
                self._deferred_n -= 1
                if self.tcache.query(t):
                    self.metrics["dedup_drop"] += 1
                    continue
                if not self._host_verify_payload(p):
                    self.metrics["verify_fail"] += 1
                    continue
                if self.tcache.insert(t):
                    self.metrics["dedup_drop"] += 1
                    continue
                if self._wait_credits():
                    self.out_ring.publish(p, sig=t)
                    self.metrics["tx"] += 1

    def _wait_credits(self) -> bool:
        """Block until the out ring has credits; one backpressure event
        per stall. Returns False if the tile is halted while waiting."""
        if not self.out_fseqs or self.out_ring.credits(self.out_fseqs) > 0:
            return True
        self.metrics["backpressure"] += 1
        bp_t0 = monotonic_ns()
        spins = 0
        while self.out_ring.credits(self.out_fseqs) <= 0:
            spins += 1
            if spins % 256 == 0:
                if self._cnc is not None:
                    self._cnc.heartbeat()
                    if self._cnc.state != CNC_RUN:
                        return False
                time.sleep(50e-6)
        if self._trace is not None:
            # the whole credit stall as one span on the out link
            self._trace.span(trace_ev.EV_BACKPRESSURE, bp_t0,
                             link=self._trace_link)
        return True

    def flush(self):
        """Dispatch a held window, then retire every in-flight batch (halt
        path)."""
        if self._hold_n:
            self._flush_hold()
        self._drain(block=True)

    def on_halt(self):
        self.flush()

    def run(self, cnc, spin_limit: int | None = None):
        """Stem-style loop: poll until cnc leaves RUN (or spin budget)."""
        spins = 0
        self._cnc = cnc
        cnc.state = CNC_RUN
        while cnc.state == CNC_RUN:
            if not self.poll_once():
                spins += 1
                if spin_limit and spins > spin_limit:
                    break
            else:
                spins = 0
            cnc.heartbeat()
        self.flush()
