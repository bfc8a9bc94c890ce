"""Verify tile on the card: the port of firedancer_tpu/tiles/verify.py.

  in ring (txn payloads) --C++ gather--> one pinned staging buffer
    --one H2D copy, cuda_ed.verify_batch (SHA-512 + fused verify
      kernels)--> verdicts --tcache dedup on first sig--> out ring

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

Out of scope in this slice, and refused with NotImplementedError naming
the ROADMAP.md item: mode="bulk_prefilter", devices > 1, coalesce_us,
chaos and trace. There is no CPU fallback: a device error propagates.
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
from ..ops import cuda_ed
from ..protocol.txn import MTU
from ..runtime import CNC_RUN, Ring, Tcache
from ..runtime.tango import lib as _lib
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


class VerifyTile:
    def __init__(self, in_ring: Ring, out_ring: Ring, tcache: Tcache,
                 batch: int = 256, max_len: int = MTU, out_fseqs=None,
                 dedup_seed: bytes | None = None,
                 rr_cnt: int = 1, rr_idx: int = 0, devices: int = 1,
                 chaos: dict | None = None, trace=None,
                 coalesce_us: float = 0.0, mode: str = "strict",
                 device="cuda"):
        if mode == "bulk_prefilter":
            raise NotImplementedError(
                f"mode='bulk_prefilter' (RLC kernels 3-4) is {_ROADMAP} "
                f"item 3")
        if mode != "strict":
            raise ValueError(f"unknown verify mode {mode!r} "
                             f"(strict | bulk_prefilter)")
        if int(devices) > 1:
            raise NotImplementedError(f"devices > 1 is {_ROADMAP} item 7 "
                                      f"(multi-GPU)")
        if chaos or trace is not None or float(coalesce_us):
            raise NotImplementedError(
                f"chaos, trace and coalesce_us are {_ROADMAP} item 2")
        self.dev = _device.resolve(device)
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
        self.compile_ns = monotonic_ns() - warmup_t0

    def _device_verify(self, bs: _StageBuf) -> _Verdicts:
        """One H2D copy of the whole staging set, the lanes split by
        slicing, the kernels, the verdicts' D2H copy and an event after
        it. Never waits; the staging set stays untouched until the event
        completes (the _bufset_fut guard)."""
        b, mlen = self.batch, self.max_len
        dev = bs.dev
        dev.copy_(bs.host, non_blocking=True)
        o_sig, o_pub = 4 * b, (4 + 64) * b
        o_msg = o_pub + 32 * b
        ln = dev[:o_sig].view(torch.int32)       # little-endian int32
        ok = cuda_ed.verify_batch(
            dev[o_sig:o_pub].view(b, 64), dev[o_pub:o_msg].view(b, 32),
            dev[o_msg:].view(b, mlen), ln, device=self.dev)
        bs.ok_host.copy_(ok, non_blocking=True)
        event = None
        if self.dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Verdicts(bs, event)

    def _dispatch(self, bs: _StageBuf) -> _Verdicts:
        t0 = monotonic_ns()
        fut = self._device_verify(bs)
        self.tpu_hist.add(monotonic_ns() - t0)
        return fut

    def poll_once(self) -> int:
        """Gather -> parse -> ha-dedup -> async device verify -> (queue)
        -> publish. Returns the number of frags consumed (0 only when
        the ring was idle)."""
        self._drain(block=False)
        n, self.seq, buf, sizes, sigs, ovr, seqs = self.in_ring.gather(
            self.seq, self.batch, self.max_len, want_seqs=True)
        self.metrics["overruns"] += ovr
        if not n:
            # idle ingest: in-flight batches always retire
            if self._pending:
                self._drain(block=True)
            return 0
        consumed = n
        if self.rr_cnt > 1:
            mine = (seqs[:n] % self.rr_cnt) == self.rr_idx
            buf, sizes = buf[:n][mine], sizes[:n][mine]
            n = int(mine.sum())
            if not n:
                return consumed
        else:
            buf, sizes = buf[:n], sizes[:n]
        self.metrics["rx"] += n
        self._process_batch(buf, sizes, n)
        return consumed

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
                self._bufset_fut[k].result()
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
            fut = self._dispatch(bs)
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
        for fut, live in rec["chunks"]:
            lane_ok = fut.result()
            covered[live] = True
            # a txn passes only if ALL its signature lanes verified
            failed = live[~lane_ok[:len(live)]]
            txn_ok[failed] = False
        txn_ok &= covered
        if rec["chunks"]:
            self.tpu_hist.add(monotonic_ns() - rb_t0)
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
            start, pub = self.out_ring.publish_batch(
                rec["buf"], rec["sizes"], rec["tags"], mask,
                fseqs=self.out_fseqs, start=start)
            fwd += pub
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
        spins = 0
        while self.out_ring.credits(self.out_fseqs) <= 0:
            spins += 1
            if spins % 256 == 0:
                if self._cnc is not None:
                    self._cnc.heartbeat()
                    if self._cnc.state != CNC_RUN:
                        return False
                time.sleep(50e-6)
        return True

    def flush(self):
        """Retire every in-flight batch (halt path)."""
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
