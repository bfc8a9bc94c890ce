"""Tile adapters + registry: kind string -> runnable tile object (copy of
the adapters of the JAX package's disco/tiles.py that the port's paths
run: synth, verify, dedup and sink on the sigverify path; pack, bank,
poh, shred and sign on the leader's loop, with resolv ahead of pack and
the exec tile family behind the bank when execution is scaled out;
shred in recover mode and replay on the follower's, with repair, tower
and send on the voting non-leader's; sock, quic and gossip at the front
door;
the cold-start follower's snapld, snapdc and snapin with the replay's
restore gate, the archiver and playback tiles, and the fdtune controller
and fdflight recorder), and the exec fan-out engine (ExecFanout) the
bank and the replay share.

An adapter is constructed inside the tile process from (TileCtx, args)
and supplies the stem callbacks (poll_once / metrics_items / in_seqs /
on_halt); ref: src/disco/topo/fd_topo.h:664-684.

Where the copy differs from the reference:
  * the registry holds these twenty-six kinds only (the twenty-five
    above and the metric tile); `Topology.tile` refuses every other kind
    of the reference's registry (disco/unported.py), and `adapter_class`
    raises ValueError for a name without an adapter;
  * VerifyAdapter wraps the port's VerifyTile, which runs on the card
    unless its `device` arg (default "cuda") says "cpu"; that arg is the
    port's counterpart of the reference's FDTPU_JAX_PLATFORM override
    (tiles.py:120-133). It takes `device_retries` and
    `device_timeout_s`, never the reference's `device_fail_limit`
    (`Topology.tile` refuses it: the port does not degrade to the CPU,
    tiles/verify.py). Its housekeeping reads the fdtune knobs as the
    reference's does (tiles.py:373-386): `coalesce_us` into the tile's
    coalesce window, `bulk_prefilter` into `prefilter_shed` in
    bulk_prefilter mode only. Its device
    series are the reference's names (tiles.py:303-314, :355-427):
    `tpu_jit_compiles` counts the kernel entry points the process
    loaded through ops/_build.py (prof/device.kernel_loads),
    `tpu_jit_cache_miss` those loaded after the warmup (the reference's:
    compiles past the first), `tpu_mem_bytes` is
    torch.cuda.memory_allocated of the tile's card (0 on the CPU), and
    a profiled tile's housekeeping serves the capture doorbell with a
    torch.profiler window (prof/device.py);
  * the trace hooks are the reference's: EV_PUBLISH on synth, verify
    and dedup, EV_CONSUME on verify, dedup, sink and shred (the
    reference's `_gather_all`, tiles.py:38-60), as one vectorized
    append a batch; a publish record carries the time taken before its
    `publish_batch`, not after it as in the reference, so a consume
    never sorts before the publish it follows;
  * PackAdapter refuses `bundle_in` (the bundle tile, item 13);
  * BankAdapter runs exec="svm" (the wave executor, svm/executor.py, on
    the card unless its `device` arg says "cpu"; or, with `exec_links`,
    the exec tile family over the shm store), exec="general" (the full
    host SVM of svm/programs.py a microblock, with the epoch boundary's
    stake history and partitioned rewards) and exec="stub"; it refuses
    the RPC and WebSocket surfaces (`rpc_port`, `ws_port`, item 16); its
    `genesis_ckpt` restores a process funk (utils/checkpt.funk_restore)
    and, as in the reference, is refused with exec links. With
    exec="svm" it boots by running one one-transfer wave through the
    kernel, so a kernel that does not build or launch fails the tile's
    boot, and it counts the kernel launches it makes after that in its
    `wave_launches` metric; its tpu histogram holds two host-clock spans
    a wave: staging plus dispatch, and finalize (the wait on the wave's
    CUDA event, the copy back and the commit). With exec="general" it
    builds the WaveExecutor on its `device` as the reference does and
    launches nothing: its tpu histogram holds one host-clock span a
    microblock's execution. A process-funk bank (svm or general) takes
    the port's own `final_ckpt` arg: at its halt it writes its store's
    root there (utils/checkpt.funk_checkpt, uncompressed, by a rename),
    so a drill can hold the store to an oracle after the tile is gone;
  * ShredAdapter runs mode="leader" and mode="recover" (the follower's
    FEC resolution, store and reassembly, tiles/shred.py
    ShredRecoverCore);
  * ExecAdapter takes a `device` arg (default "cuda") for its
    WaveExecutor, boots by running one one-transfer wave through the
    wave-scan kernel (as the bank does) and counts later launches in
    `wave_launches`; its housekeeping reads the fdtune `exec_dispatch`
    knob into its gather depth, as the reference's;
  * ReplayAdapter runs the replay (tiles/replay.py), in process or over
    the exec fan-out, with its PoH check and bank hash on the card
    unless its `device` arg says "cpu", and the follower's cold start
    (`wait_restore`: the restore gate folds the whole restored store on
    the device) and snapshot writer (`snapshot_path`, `snapshot_every`,
    `snapshot_compress`). It boots by running lthash_of_root
    over its genesis and a one-entry poh_verify on its device (a kernel
    that does not build or launch fails the boot), counts later
    launches in `poh_launches` and `lthash_launches`, and its tpu
    histogram holds each slot's host-clock spans of the PoH check and
    the bank-hash fold, and the restore gate's; its `restore_*_us`
    metrics split the gate (the port's own, beside the reference's);
  * SnapLdAdapter, SnapDcAdapter and ArchiverAdapter/PlaybackAdapter
    are the reference's; SnapInAdapter takes a `device` (default
    "cuda") for format="archive"'s lattice check, and snapdc and
    format="archive" raise at construction without the `zstandard`
    package, naming it;
  * RepairAdapter and SendAdapter give their keyguard clients the
    tile's cnc, so a sign wait ends at a halt (SignHalted, as the shred
    tile's), and close their sockets on halt; TowerAdapter publishes its
    vote through `publish_wave`, which a halt ends while backpressured;
    the tower and send tiles build and parse the vote frame with
    tiles/tower.py's `pack_tower_vote` and `parse_tower_vote`;
  * SignAdapter refuses a `keyswitch_off` in its plan entry: the port's
    plan carves no keyswitch region for the live identity hot-swap
    (topo.py:460-465 in the reference, item 13);
  * SockAdapter, QuicAdapter and GossipAdapter police their doors with
    the plan's [shed] section and their own `shed` override
    (disco/shed.py); their housekeeping reads the topology's pressure
    (`_shed_slo_poll`: a breach on the metric tile trips the door, and
    the fdtune `shed_tighten` knob scales the per-peer admit rate), as
    the repair tile's does. QuicAdapter raises at construction without
    the `cryptography` package, naming it (waltz/quic.py). GossipAdapter
    takes a `device` arg (default "cuda") for gossvf and raises at
    construction when `device_verify` is set and that device is not
    usable; gossvf is not profiled (no capture doorbell on the gossip
    tile);
  * MetricAdapter is the reference's (tiles.py:2844-2985): /metrics,
    /summary.json and /healthz from shm, and the SLO engine at its
    housekeeping, which rings each [prof] breach_capture tile's
    doorbell on a breach. It reads only shared memory and touches no
    device; /summary.json's `catchup` block reads the replay tile's
    metrics as the reference's does;
  * ControllerAdapter and FlightAdapter are the reference's
    (tiles.py:2986-3060): the knob mailbox's single writer
    (tune/controller.py) and the archive's recorder
    (flight/recorder.py). Neither runs a kernel, so neither imports
    torch.
"""
from __future__ import annotations

import hashlib
import json
import struct
import time

import numpy as np

from .. import device as _device
from ..keyguard.tile import SignHalted
from ..protocol.txn import MTU
from ..runtime import CNC_RUN
from ..trace import events as trace_ev
from ..utils.chaos import TRAFFIC_ACTIONS, attack_frames
from ..utils.tempo import monotonic_ns
from .unported import refuse

REGISTRY: dict[str, type] = {}


def register(kind: str):
    def deco(cls):
        REGISTRY[kind] = cls
        cls.kind = kind
        return cls
    return deco


def adapter_class(kind: str) -> type:
    """The adapter of a kind; ValueError for a name without one."""
    if kind not in REGISTRY:
        raise ValueError(f"unknown tile kind {kind!r}")
    return REGISTRY[kind]


def _single(d: dict, what: str, tile: str):
    if len(d) != 1:
        raise ValueError(f"tile {tile}: expected exactly one {what}, "
                         f"got {list(d)}")
    return next(iter(d.values()))


def _trace_consume(ctx, link: str, sigs, n: int):
    """Consume lineage of one gather (the reference's `_gather_all`
    hook): one vectorized append, nothing when untraced."""
    tr = getattr(ctx, "trace", None)
    if tr is not None and n:
        tr.frag_batch(trace_ev.EV_CONSUME, sigs[:n], link=tr.link_id(link))


def publish_wave(out, fseqs, frames, cnc=None, on_stall=None) -> int:
    """THE batched wave egress: one credit-gated publish_batch over
    (sig, payload) rows with stop-row resume on a mid-wave stall.
    Stalls are visible (`on_stall` per stall tick) and heartbeat; a
    tile that leaves RUN while backpressured ABORTS the wave instead
    of spinning forever (a dead or halting consumer must never wedge a
    producer's halt path). Returns rows published. Shared by
    pack/bank/poh so the stall policy lives in one place."""
    k = len(frames)
    if not k:
        return 0
    wb = np.zeros((k, max(len(f) for _, f in frames)), np.uint8)
    sz = np.zeros(k, np.uint32)
    ids = np.zeros(k, np.uint64)
    for i, (sig, f) in enumerate(frames):
        wb[i, :len(f)] = np.frombuffer(f, np.uint8)
        sz[i] = len(f)
        ids[i] = sig
    start, total = 0, 0
    while True:
        stop, pub = out.publish_batch(
            wb, sz, ids, np.ones(k, np.uint8), fseqs=fseqs,
            start=start)
        total += pub
        start = stop
        if start >= k:
            return total
        if on_stall is not None:
            on_stall()
        if cnc is not None:
            cnc.heartbeat()
            if cnc.state != CNC_RUN:
                return total      # halted while backpressured: abort
        time.sleep(20e-6)


def _synth_genesis(n: int) -> dict:
    """Fund the deterministic synth signer pool (wraps mod its size):
    the ONE genesis map the leader bank derives from a config count."""
    from ..tiles.synth import synth_signer_seed
    from ..utils.ed25519_ref import keypair
    out = {}
    seen = set()
    for i in range(n):
        seed = synth_signer_seed(i)
        if seed in seen:
            break
        seen.add(seed)
        out[keypair(seed)[-1]] = 1 << 44
    return out


@register("synth")
class SynthAdapter:
    """Load generator (the reference's benchg tile,
    ref: src/app/shared_dev/commands/bench/fd_benchg_tile.c).
    args: count (total txns), unique, seed, burst, rate_tps (0 =
    unpaced; token-bucket pacing for an offered-load sweep). rate_tps
    may also be a RAMP SCHEDULE, a list of (duration_s, tps) stanzas;
    past the schedule's end the last stanza's rate holds."""

    METRICS = ["tx", "backpressure", "attack_tx", "attack_drop"]

    def __init__(self, ctx, args):
        from ..tiles.synth import make_signed_txns
        self.ctx = ctx
        self.count = int(args.get("count", 1024))
        # traffic plans (utils/chaos.TRAFFIC_ACTIONS): the stem fires
        # them into on_chaos, which floods the out ring
        self.attack_tx = 0
        self.attack_drop = 0
        self._attack_sig = 1 << 48       # ring sigs clear of tx range
        self.burst = int(args.get("burst", 32))
        rt = args.get("rate_tps", 0.0)
        if isinstance(rt, (list, tuple)) and rt:
            self.ramp = [(float(d), float(r)) for d, r in rt]
            self.rate_tps = self.ramp[0][1]
        else:
            # an EMPTY ramp list means unpaced, same as rate_tps=0
            self.ramp = None
            self.rate_tps = 0.0 if isinstance(rt, (list, tuple)) \
                else float(rt)
        self._t0 = None               # pacing clock starts on first poll
        n_unique = min(self.count, int(args.get("unique", 64)))
        txns = make_signed_txns(n_unique, seed=int(args.get("seed", 0)))
        self.out = _single(ctx.out_rings, "out link", ctx.tile_name)
        self.fseqs = _single(ctx.out_fseqs, "out link", ctx.tile_name)
        # pre-render the unique-frame pool ONCE into one padded buffer
        # and replay it: each burst is one native credit-gated batch
        # publish
        stride = max((len(t) for t in txns), default=1)
        self._buf = np.zeros((n_unique, stride), np.uint8)
        self._sizes = np.zeros(n_unique, np.uint32)
        for i, t in enumerate(txns):
            self._buf[i, :len(t)] = np.frombuffer(t, np.uint8)
            self._sizes[i] = len(t)
        self._n_unique = n_unique
        self.sent = 0
        self.bp = 0

    def poll_once(self) -> int:
        if self.sent >= self.count or not self._n_unique:
            return 0
        b = min(self.burst, self.count - self.sent)
        if self.ramp is not None or self.rate_tps > 0:
            # offered-load pacing: publish no faster than the token
            # budget elapsed wall time has earned
            if self._t0 is None:
                self._t0 = time.perf_counter()
            b = min(b, self._earned(time.perf_counter() - self._t0)
                    - self.sent)
            if b <= 0:
                return 0
        idx = np.arange(self.sent, self.sent + b) % self._n_unique
        tr = getattr(self.ctx, "trace", None)
        # lineage stamps are taken before the frags become visible
        pub_ts = monotonic_ns() if tr is not None else 0
        stop, pub = self.out.publish_batch(
            self._buf[idx], self._sizes[idx],
            np.arange(self.sent, self.sent + b, dtype=np.uint64),
            np.ones(b, np.uint8), fseqs=self.fseqs)
        if stop < b:
            self.bp += 1
        if tr is not None and pub:
            tr.frag_batch(
                trace_ev.EV_PUBLISH,
                np.arange(self.sent, self.sent + pub, dtype=np.uint64),
                link=tr.link_id(next(iter(self.ctx.out_rings))),
                ts_ns=pub_ts)
        self.sent += pub
        return pub

    def on_chaos(self, ev: dict):
        """A traffic plan's event (the stem has recorded it): render the
        attack pool and flood the out ring. Credit-gated but never a
        spin: what the ring refuses twice in a row is dropped newest
        first (attack_drop)."""
        if ev["action"] not in TRAFFIC_ACTIONS:
            return
        frames = attack_frames(ev["action"], ev["frames"], seed=ev["seed"])
        if not frames:
            return
        k = len(frames)
        wb = np.zeros((k, max(len(f) for f in frames)), np.uint8)
        sz = np.zeros(k, np.uint32)
        for i, f in enumerate(frames):
            wb[i, :len(f)] = np.frombuffer(f, np.uint8)
            sz[i] = len(f)
        sigs = np.arange(self._attack_sig, self._attack_sig + k,
                         dtype=np.uint64)
        self._attack_sig += k
        start = 0
        stalls = 0
        while start < k:
            stop, pub = self.out.publish_batch(
                wb, sz, sigs, np.ones(k, np.uint8),
                fseqs=self.fseqs, start=start)
            self.attack_tx += pub
            if stop == start:
                stalls += 1
                if stalls >= 2:          # no credits twice: drop the rest
                    self.attack_drop += k - start
                    break
                time.sleep(50e-6)
                continue
            stalls = 0
            start = stop

    def _earned(self, dt: float) -> int:
        """Token budget earned after dt seconds: flat rate, or the ramp
        schedule's integral (holding the last stanza's rate past the
        end)."""
        if self.ramp is None:
            return int(dt * self.rate_tps)
        total = 0.0
        for d, r in self.ramp:
            if dt <= d:
                return int(total + dt * r)
            total += d * r
            dt -= d
        return int(total + dt * self.ramp[-1][1])

    def metrics_items(self):
        return {"tx": self.sent, "backpressure": self.bp,
                "attack_tx": self.attack_tx,
                "attack_drop": self.attack_drop}


@register("verify")
class VerifyAdapter:
    """Sigverify tile on the card (ref: src/disco/verify/fd_verify_tile.h)
    over the port's tiles/verify.py::VerifyTile.
    args: batch, max_len, tcache (name), rr_cnt, rr_idx, devices,
    device_retries, device_timeout_s, chaos (fault plan), coalesce_us,
    mode ("strict" | "bulk_prefilter"), prefilter_shed,
    device ("cuda" | "cpu")."""

    METRICS = ["rx", "parse_fail", "dedup_drop", "verify_fail", "tx",
               "overruns", "batches", "backpressure", "device_errors",
               "cpu_fallback", "rlc_batches", "rlc_pass", "rlc_lanes",
               "rlc_shed", "rlc_ns",
               # device telemetry, promoted by the prometheus renderer
               # to fdtpu_tile_tpu_* series: kernel entry points loaded,
               # those loaded after the warmup, batches in flight, card
               # bytes allocated
               "tpu_jit_compiles", "tpu_jit_cache_miss",
               "tpu_inflight", "tpu_mem_bytes",
               # the boot warmup's wall time (the kernels' build and
               # first launch), and device-capture windows served
               "tpu_compile_ns", "prof_captures"]
    GAUGES = ["cpu_fallback", "tpu_jit_compiles", "tpu_jit_cache_miss",
              "tpu_inflight", "tpu_mem_bytes", "tpu_compile_ns"]
    DEVICE_SERIES = ["tpu_jit_compiles", "tpu_jit_cache_miss",
                     "tpu_inflight", "tpu_mem_bytes", "tpu_compile_ns"]

    def __init__(self, ctx, args):
        from ..tiles.verify import VerifyTile
        self.ctx = ctx
        in_ring = _single(ctx.in_rings, "in link", ctx.tile_name)
        out_ring = _single(ctx.out_rings, "out link", ctx.tile_name)
        tc_name = args.get("tcache")
        tc = ctx.tcaches[tc_name] if tc_name \
            else _single(ctx.tcaches, "tcache", ctx.tile_name)
        tr = getattr(ctx, "trace", None)
        links = [0, 0] if tr is None else [
            tr.link_id(next(iter(ctx.out_rings))),
            tr.link_id(next(iter(ctx.in_rings)))]
        timeout = args.get("device_timeout_s")
        self.tile = VerifyTile(
            in_ring, out_ring, tc,
            batch=int(args.get("batch", 256)),
            max_len=int(args.get("max_len", MTU)),
            out_fseqs=_single(ctx.out_fseqs, "out link", ctx.tile_name),
            dedup_seed=bytes.fromhex(ctx.plan["seed"]),
            rr_cnt=int(args.get("rr_cnt", 1)),
            rr_idx=int(args.get("rr_idx", 0)),
            devices=int(args.get("devices", 1)),
            device_retries=int(args.get("device_retries", 2)),
            device_timeout_s=None if timeout is None else float(timeout),
            chaos=args.get("chaos"), trace=tr, trace_link=links[0],
            trace_link_in=links[1],
            coalesce_us=float(args.get("coalesce_us", 0.0)),
            mode=args.get("mode", "strict"),
            prefilter_shed=bool(args.get("prefilter_shed", True)),
            device=args.get("device", "cuda"))
        self.tile._cnc = ctx.cnc
        self.in_link = next(iter(ctx.in_rings))
        self.tile.seq = ctx.in_seq0.get(self.in_link, 0)
        # device-time attribution: the stem flushes this accumulator
        # into the tile's third (tpu) histogram slot
        self.tpu_hist = self.tile.tpu_hist
        # fdprof device side, polled at housekeeping, never in the hot
        # loop: kernel-load events (EV_COMPILE, and a manifest when
        # profiled) and the capture doorbell
        from ..prof.device import CompileWatch, DeviceCapture, kernel_loads
        self._boot_loads = kernel_loads()
        prof = getattr(ctx, "prof", None)
        self._compile_watch = CompileWatch(
            ctx.plan, ctx.tile_name, kernel_loads, trace=tr,
            mem_fn=self._device_mem, manifest=prof is not None,
            boot=self._boot_loads)
        # a tile a breach captures warms the profiler at boot (CUPTI's
        # start-up took seconds: prof/device.py)
        warm = ctx.tile_name in ((ctx.plan.get("prof") or {})
                                 .get("breach_capture") or ())
        self._capture = DeviceCapture(
            ctx.plan, ctx.tile_name, prof, trace=tr,
            device=str(self.tile.dev), warm=warm) \
            if prof is not None else None

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def housekeeping(self):
        self._compile_watch.poll()
        if self._capture is not None:
            self._capture.poll()
        knobs = getattr(self.ctx, "knobs", None)
        if knobs is not None:
            v = knobs.get("coalesce_us")
            if v is not None:
                self.tile.set_coalesce_ns(v * 1_000)
            v = knobs.get("bulk_prefilter")
            if v is not None and self.tile.mode == "bulk_prefilter":
                # arming/relaxing the shed path is runtime-safe; the
                # MODE (the kernel family) never switches live
                self.tile.prefilter_shed = bool(v)

    def on_halt(self):
        if self._capture is not None:
            self._capture.flush()   # never leave the doorbell hanging
        self.tile.flush()      # publish verdicts already in flight

    def in_seqs(self):
        return {self.in_link: self.tile.seq}

    def _device_mem(self) -> int:
        """Bytes the caching allocator holds for tensors on the tile's
        card; 0 on the CPU."""
        if self.tile.dev.type != "cuda":
            return 0
        import torch
        return int(torch.cuda.memory_allocated(self.tile.dev))

    def metrics_items(self):
        from ..prof.device import kernel_loads
        m = dict(self.tile.metrics)
        loads = kernel_loads()
        m["tpu_jit_compiles"] = loads
        m["tpu_jit_cache_miss"] = max(0, loads - self._boot_loads)
        m["tpu_inflight"] = len(self.tile._pending)
        m["tpu_mem_bytes"] = self._device_mem()
        m["tpu_compile_ns"] = self.tile.compile_ns
        m["prof_captures"] = self._capture.captures \
            if self._capture is not None else 0
        return m


@register("dedup")
class DedupAdapter:
    """Global dedup stage across verify outs
    (ref: src/disco/dedup/fd_dedup_tile.c:9-20: one tcache over all
    verify tile outputs; tags were computed upstream with the shared
    per-boot seed, carried in the frag sig field).
    args: tcache (name), batch."""

    METRICS = ["rx", "dup", "tx", "overruns", "backpressure"]

    def __init__(self, ctx, args):
        self.ctx = ctx
        self.batch = int(args.get("batch", 64))
        tc_name = args.get("tcache")
        self.tcache = ctx.tcaches[tc_name] if tc_name \
            else _single(ctx.tcaches, "tcache", ctx.tile_name)
        self.out = _single(ctx.out_rings, "out link", ctx.tile_name)
        self.out_fseqs = _single(ctx.out_fseqs, "out link", ctx.tile_name)
        self.seqs = ctx.in_seqs0()
        self.mtu = max(ctx.plan["links"][ln]["mtu"] for ln in ctx.in_rings)
        self.m = {k: 0 for k in self.METRICS}
        # trace link ids resolved once
        self._tr = getattr(ctx, "trace", None)
        if self._tr is not None:
            self._tr_out = self._tr.link_id(next(iter(ctx.out_rings)))
            self._tr_ins = {ln: self._tr.link_id(ln) for ln in ctx.in_rings}

    def poll_once(self) -> int:
        tr = self._tr
        total = 0
        for ln, ring in self.ctx.in_rings.items():
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], self.batch, self.mtu)
            self.m["overruns"] += ovr
            if not n:
                continue
            total += n
            self.m["rx"] += n
            if tr is not None:
                tr.frag_batch(trace_ev.EV_CONSUME, sigs[:n],
                              link=self._tr_ins[ln])
            # the whole gather dedups as ONE native insert-or-dup call
            # and forwards as credit-gated native batch publishes
            dup = self.tcache.insert_batch(sigs[:n])
            self.m["dup"] += int(dup.sum())
            mask = (dup == 0).astype(np.uint8)
            start = 0
            while True:
                # lineage stamps are taken before the frags become visible
                pub_ts = monotonic_ns() if tr is not None else 0
                stop, pub = self.out.publish_batch(
                    buf[:n], sizes[:n], sigs[:n], mask,
                    fseqs=self.out_fseqs, start=start)
                self.m["tx"] += pub
                if tr is not None and pub:
                    live = sigs[start:stop][mask[start:stop] != 0]
                    tr.frag_batch(trace_ev.EV_PUBLISH, live,
                                  link=self._tr_out, ts_ns=pub_ts)
                start = stop
                if start >= n:
                    break
                # out of downstream credits mid-batch: stall visibly,
                # resume from the stop row (fd_fctl discipline)
                self.m["backpressure"] += 1
                time.sleep(20e-6)
        return total

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return dict(self.m)


@register("sink")
class SinkAdapter:
    """Terminal consumer: counts frags (the reference's bencho TPS
    observer, ref: src/app/shared_dev/commands/bench/fd_bencho_tile.c).
    args: batch."""

    METRICS = ["rx", "bytes", "overruns"]

    def __init__(self, ctx, args):
        self.ctx = ctx
        self.batch = int(args.get("batch", 64))
        self.seqs = ctx.in_seqs0()
        self.mtu = max(ctx.plan["links"][ln]["mtu"] for ln in ctx.in_rings)
        self.m = {k: 0 for k in self.METRICS}

    def poll_once(self) -> int:
        # the whole gather tallies vectorized (one sizes-sum per batch)
        total = 0
        for ln, ring in self.ctx.in_rings.items():
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], self.batch, self.mtu)
            self.m["overruns"] += ovr
            if not n:
                continue
            self.m["rx"] += n
            self.m["bytes"] += int(sizes[:n].sum())
            _trace_consume(self.ctx, ln, sigs, n)
            total += n
        return total

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return dict(self.m)


@register("pack")
class PackAdapter:
    """Leader scheduler tile (ref: src/disco/pack/fd_pack_tile.c):
    inserts txns from the dedup stage, emits non-conflicting
    microblocks to parallel bank tiles, retires account locks on bank
    completion frags.

    Microblock wire format (one frag): u16 bank | u16 txn_cnt |
    u64 microblock_id | u64 slot | (u16 len | payload)*.
    Completion frag: u64 microblock_id (per-bank dedicated link).

    Wave discipline: up to `wave` microblocks are outstanding per bank
    (the scheduler's FIFO), the whole per-poll wave for a bank ships as
    ONE credit-gated publish_batch on its link, and completion frags
    drain as one gather pass per done link.

    args: txn_in (link), resolved_in (txn_in carries the resolv tile's
    RESOLVED frames), bank_links (ordered list), done_links (ordered
    list, one per bank), max_txn_per_microblock, wave (max outstanding
    microblocks per bank), batch, and the slot boundary source: slot_in
    (link carrying PoH slot frags, ref fd_poh.h leader slot handoff) or
    slot_ms (wall-clock fallback for poh-less topologies)."""

    METRICS = ["rx", "parse_fail", "inserted", "scheduled", "microblocks",
               "completions", "blocks", "backpressure", "overruns"]

    def __init__(self, ctx, args):
        from ..pack import PackLimits, PackScheduler
        from ..pack.scheduler import meta_from_payload, meta_from_resolved
        if args.get("bundle_in"):
            refuse("pack arg 'bundle_in' (the bundle tile)", 13)
        # resolved_in: txn_in carries RESOLVED frames from a resolv tile
        # (account sets and cost computed upstream, the reference's
        # resolv -> pack seam)
        self._meta_from_payload = (meta_from_resolved
                                   if args.get("resolved_in")
                                   else meta_from_payload)
        self.ctx = ctx
        self.txn_in = args["txn_in"]
        self.bank_links = list(args["bank_links"])
        self.done_links = list(args["done_links"])
        if len(self.bank_links) != len(self.done_links):
            raise ValueError(
                f"pack {ctx.tile_name}: bank_links and done_links must "
                f"pair up, got {self.bank_links} / {self.done_links}")
        n_banks = len(self.bank_links)
        mtu = min(ctx.plan["links"][ln]["mtu"] for ln in self.bank_links)
        self.sched = PackScheduler(
            bank_cnt=n_banks,
            limits=PackLimits(
                max_txn_per_microblock=int(
                    args.get("max_txn_per_microblock", 31)),
                max_data_bytes_per_microblock=mtu - 20))
        self.slot_in = args.get("slot_in")
        self.slot_ms = float(args.get("slot_ms", 400.0))
        self._slot_t0 = time.monotonic()
        self.batch = int(args.get("batch", 64))
        self.wave = max(1, int(args.get("wave", 4)))
        self.seqs = ctx.in_seqs0()
        self.in_mtu = ctx.plan["links"][self.txn_in]["mtu"]
        from collections import deque
        # outstanding microblock ids per bank, FIFO (wave depth deep;
        # the scheduler holds the matching lock masks in its own queue)
        self.busy = [deque() for _ in range(n_banks)]
        self._next_mb = 0
        self.cur_slot = 0                 # advanced by PoH slot frags
        self.m = {k: 0 for k in self.METRICS}

    def _serialize(self, bank: int, mb_id: int, metas) -> bytes:
        out = bytearray(struct.pack("<HHQQ", bank, len(metas), mb_id,
                                    self.cur_slot))
        for m in metas:
            out += struct.pack("<H", len(m.payload)) + m.payload
        return bytes(out)

    def poll_once(self) -> int:
        total = 0
        # 1) retire completions in batch (frees account locks first, the
        # reference's poll order, so banks never starve); completions
        # arrive in the bank's FIFO execution order
        for bank, ln in enumerate(self.done_links):
            ring = self.ctx.in_rings[ln]
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], self.batch, 64)
            self.m["overruns"] += ovr
            q = self.busy[bank]
            for mb_id in sigs[:n].tolist():
                if q and q[0] == mb_id:
                    q.popleft()
                    self.sched.microblock_done(bank)
                    self.m["completions"] += 1
            total += n
        # 2) ingest new txns
        ring = self.ctx.in_rings[self.txn_in]
        n, self.seqs[self.txn_in], buf, sizes, sigs, ovr = ring.gather(
            self.seqs[self.txn_in], self.batch, self.in_mtu)
        self.m["overruns"] += ovr
        for i in range(n):
            try:
                self.sched.insert(
                    self._meta_from_payload(bytes(buf[i, :sizes[i]])))
                self.m["inserted"] += 1
            except Exception:
                self.m["parse_fail"] += 1
        self.m["rx"] += n
        total += n
        # 2b) PoH slot boundaries (tick-count-driven, not wall clock)
        if self.slot_in:
            ring = self.ctx.in_rings[self.slot_in]
            k, self.seqs[self.slot_in], buf, sizes, sigs, ovr = \
                ring.gather(self.seqs[self.slot_in], 4, 16)
            self.m["overruns"] += ovr
            for i in range(k):
                self.sched.end_block()
                self.m["blocks"] += 1
                # slot frag payload = u64 completed slot (poh tile)
                (done_slot,) = struct.unpack_from("<Q", buf[i], 0)
                self.cur_slot = done_slot + 1
            total += k
        # 3) fill banks in WAVES: schedule up to the per-bank wave
        # budget (bounded by the link's credit window so the batched
        # publish below cannot stall mid-wave against a live consumer),
        # and ship the whole wave as ONE publish_batch per bank link
        for bank, ln in enumerate(self.bank_links):
            out = self.ctx.out_rings[ln]
            fseqs = self.ctx.out_fseqs[ln]
            room = self.wave - len(self.busy[bank])
            if room <= 0:
                continue
            if fseqs:
                cr = out.credits(fseqs)
                if cr <= 0:
                    self.m["backpressure"] += 1
                    continue
                room = min(room, cr)
            frames = []
            while len(frames) < room:
                metas = self.sched.schedule_microblock(bank)
                if not metas:
                    break
                mb_id = self._next_mb
                self._next_mb += 1
                frames.append((mb_id,
                               self._serialize(bank, mb_id, metas)))
                self.busy[bank].append(mb_id)
                self.m["scheduled"] += len(metas)
                self.m["microblocks"] += 1
            if not frames:
                continue

            # the credit pre-check bounds the wave, so a mid-wave stall
            # can only mean a consumer rewound its fseq: stall visibly,
            # resume from the stop row, abort on halt
            def bp():
                self.m["backpressure"] += 1
            publish_wave(out, fseqs, frames,
                         cnc=getattr(self.ctx, "cnc", None),
                         on_stall=bp)
            total += len(frames)
        return total

    def housekeeping(self):
        # wall-clock slot fallback, only when no PoH slot link is wired
        if not self.slot_in and \
                (time.monotonic() - self._slot_t0) * 1e3 >= self.slot_ms:
            self.sched.end_block()
            self._slot_t0 = time.monotonic()
            self.m["blocks"] += 1
            self.cur_slot += 1
        knobs = getattr(self.ctx, "knobs", None)
        if knobs is not None:
            v = knobs.get("pack_wave")
            if v is not None:
                self.wave = max(1, v)

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return dict(self.m)


# exec-family wire: bank -> exec dispatch frame is
# u64 wave_seq | u64 xid | u16 txn_cnt, then txn_cnt x
# (32B src | 32B dst | u64 amount | u64 fee); exec -> bank completion
# frag is u64 wave_seq | u32 ok | u32 fail
_EXEC_HDR = struct.Struct("<QQH")
_EXEC_TXN = struct.Struct("<QQ")
_EXEC_TXN_SZ = 64 + _EXEC_TXN.size
_EXEC_DONE = struct.Struct("<QII")


def _conflict_groups(txns):
    """Union-find partition of a wave's transfers into account-disjoint
    conflict groups, each group in original txn order. Groups can run
    concurrently on different exec tiles without breaking the serial
    fiction; txns INSIDE a group must execute in order on one tile
    (pack only prevents conflicts against OTHER banks' outstanding
    microblocks — same-bank microblocks may conflict pairwise)."""
    parent = {}

    def find(k):
        while parent[k] != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    for t in txns:
        parent.setdefault(t.src, t.src)
        parent.setdefault(t.dst, t.dst)
        ra, rb = find(t.src), find(t.dst)
        if ra != rb:
            parent[ra] = rb
    groups = {}
    for t in txns:
        groups.setdefault(find(t.src), []).append(t)
    return list(groups.values())


class ExecFanout:
    """Sharded exec-family wave scheduler: the bank's fan-out machinery,
    which the replay tile's follower path runs too, so it catches up
    over the SAME engine the leader executes with. Owns the per-shard
    dispatch/completion rings, the one-fork-per-attempt discipline
    (wave_seq == xid: one monotonic counter identifies both the fork
    and the attempt, so a cancelled attempt's late completions can
    never alias the retry's), the conflict-group round-robin across
    shards (groups are account-disjoint across tiles; a group bigger
    than a link frame splits into consecutive frames on the SAME ring,
    executed in order at the fork layer), and timeout cancel +
    whole-wave redispatch when a shard dies mid-wave — exactly-once
    application, no wedged producer.

    The OWNER supplies on_commit(tag, xid, ok, fail), called when a
    wave fully completes: the bank publishes the fork immediately and
    flushes its poh/done frames; replay folds the fork's delta into
    the bank-hash lattice FIRST, then publishes. xid is None when the
    wave carried no transfers (no fork was prepared). `m` is the
    owner's metrics dict (needs exec_waves/exec_redispatch/overruns)."""

    def __init__(self, ctx, funk, exec_links, exec_done, m,
                 on_commit=None, redispatch_s=2.0):
        self.ctx = ctx
        self.funk = funk
        self.m = m
        self.on_commit = on_commit
        self.redispatch_s = float(redispatch_s)
        self.exec_links = list(exec_links)
        self.exec_done = list(exec_done)
        if len(self.exec_links) != len(self.exec_done):
            raise ValueError(
                f"{ctx.tile_name}: exec_links/exec_done must pair up, "
                f"got {self.exec_links} / {self.exec_done}")
        self._exec_out = [(ctx.out_rings[ln], ctx.out_fseqs[ln])
                          for ln in self.exec_links]
        self._done_rings = [ctx.in_rings[ln] for ln in self.exec_done]
        self.done_seq = {ln: ctx.in_seq0.get(ln, 0)
                         for ln in self.exec_done}
        self._exec_cap = []
        for ln in self.exec_links:
            cap = (ctx.plan["links"][ln]["mtu"] - _EXEC_HDR.size) \
                // _EXEC_TXN_SZ
            if cap < 1:
                raise ValueError(
                    f"{ctx.tile_name}: exec link {ln} mtu "
                    f"{ctx.plan['links'][ln]['mtu']} can't carry one "
                    f"dispatch txn ({_EXEC_HDR.size + _EXEC_TXN_SZ}B)")
            self._exec_cap.append(cap)
        self._next_xid = 1
        self.wave = None               # in-flight wave state

    @property
    def busy(self) -> bool:
        return self.wave is not None

    def dispatch(self, txns, tag=None):
        """Start a wave (exactly ONE outstanding — waves stay serial,
        so cross-wave conflicts need no tracking at all). `tag` rides
        the wave untouched and comes back in on_commit."""
        assert self.wave is None, "one wave outstanding"
        self.wave = {"tag": tag, "txns": list(txns), "xid": None,
                     "wave_seq": None, "remaining": 0, "ok": 0,
                     "fail": 0, "deadline": None}
        self._send()

    def _send(self):
        """(Re-)dispatch the in-flight wave under a FRESH fork:
        conflict groups round-robin across the exec tiles, each group
        intact and in order on ONE tile."""
        w = self.wave
        if not w["txns"]:
            self._commit()
            return
        xid = self._next_xid
        self._next_xid += 1
        self.funk.txn_prepare(None, xid)
        per_tile = [[] for _ in self.exec_links]
        for gi, g in enumerate(_conflict_groups(w["txns"])):
            per_tile[gi % len(per_tile)].extend(g)
        cnc = getattr(self.ctx, "cnc", None)
        sent = 0
        for ti, tl in enumerate(per_tile):
            if not tl:
                continue
            out, fseqs = self._exec_out[ti]
            cap = self._exec_cap[ti]
            frames = []
            for i in range(0, len(tl), cap):
                chunk = tl[i:i + cap]
                body = b"".join(
                    t.src + t.dst + _EXEC_TXN.pack(t.amount, t.fee)
                    for t in chunk)
                frames.append(
                    (xid, _EXEC_HDR.pack(xid, xid, len(chunk)) + body))
            publish_wave(out, fseqs, frames, cnc=cnc)
            sent += len(frames)
        w.update(xid=xid, wave_seq=xid, remaining=sent, ok=0, fail=0,
                 deadline=time.monotonic() + self.redispatch_s)
        self.m["exec_waves"] += 1

    def poll(self, allow_redispatch=True) -> int:
        """Drain completion frags; commit the wave when every dispatch
        frame completed, cancel + re-dispatch whole under a fresh fork
        on deadline (an exec tile died mid-wave and its ring rejoin
        skipped the frames) — the store stays consistent, the owner
        never wedges."""
        total = 0
        for ln, ring in zip(self.exec_done, self._done_rings):
            n, self.done_seq[ln], buf, sizes, _sigs, ovr = \
                ring.gather(self.done_seq[ln], 64, 64)
            self.m["overruns"] += ovr
            total += n
            for i in range(n):
                ws, ok, fail = _EXEC_DONE.unpack_from(
                    bytes(buf[i, :sizes[i]]), 0)
                w = self.wave
                if w is None or ws != w["wave_seq"]:
                    continue       # a cancelled attempt's leftovers
                w["remaining"] -= 1
                w["ok"] += ok
                w["fail"] += fail
        w = self.wave
        if w is not None and w["wave_seq"] is not None:
            if w["remaining"] <= 0:
                self._commit()
            elif allow_redispatch \
                    and time.monotonic() > w["deadline"]:
                self.m["exec_redispatch"] += 1
                self.funk.txn_cancel(w["xid"])
                self._send()
        return total

    def _commit(self):
        w = self.wave
        self.wave = None
        if self.on_commit is not None:
            self.on_commit(w["tag"], w["xid"], w["ok"], w["fail"])

    def halt(self):
        """Bounded drain, then cancel: a wave already dispatched gets
        redispatch_s to complete (exec tiles are halting too); after
        the window the fork is cancelled — no partial commits in the
        store, no on_commit for a wave that never finished."""
        t0 = time.monotonic()
        while self.wave is not None \
                and time.monotonic() - t0 < self.redispatch_s:
            self.poll(allow_redispatch=False)
            if self.wave is not None:
                time.sleep(0.001)
        if self.wave is not None:
            if self.wave["xid"] is not None:
                self.funk.txn_cancel(self.wave["xid"])
            self.wave = None


@register("bank")
class BankAdapter:
    """Execution stage (ref: src/discoh/bank/fd_bank_tile.c shape:
    consume microblock, execute, emit completion; execution entry
    src/flamenco/runtime/fd_runtime.h:254-266).

    exec="svm": parse each txn, execute its system-program transfers
    through the wave executor (svm/executor.py: conflict-DAG waves, one
    launch of the wave-scan kernel a wave) against a process-local funk
    fork, and forward each executed microblock (with a PoH mixin hash)
    on the optional poh link. Use one bank tile with exec="svm":
    multi-bank topologies share no account state.

    exec="general": the FULL host SVM a microblock (svm/programs.py
    TxnExecutor: every ported program, v0 through lookup tables), in the
    conflict-DAG wave order the replay uses, one funk fork a microblock;
    at the first microblock of a new epoch the bank appends each crossed
    epoch's stake history and pays its partitioned rewards
    (flamenco/stakes.py, flamenco/rewards.py), persisting the
    paid-through marker in the store.

    exec="stub": count txns and ack (ring-plumbing tests).

    Exec tile fan-out: with `exec_links`/`exec_done` the bank keeps only
    wave scheduling, commit ordering and the PoH handoff; execution
    moves to the exec tile family over the shm funk store (plan["funk"],
    backend "shm"), through ExecFanout: the gathered wave's transfers
    are partitioned into account-disjoint conflict groups, each shipped
    intact and in order to one exec tile under ONE funk fork the bank
    prepared. The bank publishes the fork only after every dispatch
    frame completed; a wave that does not complete within
    `redispatch_s` (an exec tile died mid-wave) is cancelled and
    re-dispatched whole under a fresh fork. The genesis balances are
    written into the shm store's root.

    Device-wave execution: the tile gathers up to `wave` microblocks per
    poll and executes them as ONE device dispatch. Their conflict
    tables are packed into one staging buffer whose balance-independent
    transfer is issued BEFORE the previous wave retires, so the host
    stages it while that wave computes; the previous wave then commits
    and its poh-mixin frames and completion frags publish as one
    credit-gated publish_batch per link. The serial fiction holds across
    waves because balances are read only after the prior wave's commit,
    and the conflict DAG orders intra-wave dependencies.

    args: exec, wave (microblocks per device wave), poh_link (optional
    out link name), forward_payloads, genesis ({pubkey hex: lamports}),
    genesis_synth (fund the first N synth signers), genesis_ckpt,
    slots_per_epoch (exec="general": MUST match the follower's),
    final_ckpt (the store's root at the halt, for drills), device
    ("cuda" | "cpu"), exec_links/exec_done (ordered per-exec-shard
    dispatch and completion links), redispatch_s; the done link is the
    remaining out link."""

    METRICS = ["microblocks", "txns", "transfers", "exec_skip",
               "exec_fail", "overruns", "wave_launches", "exec_waves",
               "exec_redispatch", "rewards_paid"]

    def __init__(self, ctx, args):
        for key, item in (("rpc_port", 16), ("ws_port", 16)):
            if args.get(key) is not None:
                refuse(f"bank arg {key!r}", item)
        self.exec_mode = args.get("exec", "stub")
        if self.exec_mode not in ("svm", "general", "stub"):
            raise ValueError(f"bank {ctx.tile_name}: unknown exec "
                             f"{self.exec_mode!r}")
        self.ctx = ctx
        self.exec_links = list(args.get("exec_links") or [])
        self.exec_done = list(args.get("exec_done") or [])
        if len(self.exec_links) != len(self.exec_done):
            raise ValueError(
                f"bank {ctx.tile_name}: exec_links/exec_done must "
                f"pair up, got {self.exec_links} / {self.exec_done}")
        if self.exec_links and self.exec_mode != "svm":
            raise ValueError(
                f"bank {ctx.tile_name}: exec_links need exec=\"svm\"")
        non_done = [ln for ln in ctx.in_rings if ln not in self.exec_done]
        if len(non_done) != 1:
            raise ValueError(f"bank {ctx.tile_name}: expected one in "
                             f"link, got {non_done}")
        self.in_link = non_done[0]
        self.ring = ctx.in_rings[self.in_link]
        self.poh_link = args.get("poh_link")
        done = [ln for ln in ctx.out_rings
                if ln != self.poh_link and ln not in self.exec_links]
        if len(done) != 1:
            raise ValueError(f"bank {ctx.tile_name}: expected one done "
                             f"link, got {done}")
        self.out = ctx.out_rings[done[0]]
        self.out_fseqs = ctx.out_fseqs[done[0]]
        if self.poh_link:
            self.poh_out = ctx.out_rings[self.poh_link]
            self.poh_fseqs = ctx.out_fseqs[self.poh_link]
        else:
            self.poh_out = None
        self.m = {k: 0 for k in self.METRICS}
        self.slot = 0                  # highest slot seen in microblocks
        self._rewards_epoch = None     # lazily read from the marker
        self.slots_per_epoch = int(args.get("slots_per_epoch", 432_000))
        self.fwd_payloads = bool(args.get("forward_payloads", False))
        self.final_ckpt = args.get("final_ckpt")
        if self.final_ckpt and (self.exec_mode == "stub"
                                or self.exec_links):
            raise ValueError(f"bank {ctx.tile_name}: final_ckpt needs a "
                             f"process funk (exec \"svm\" or "
                             f"\"general\", no exec_links)")
        if self.fwd_payloads and self.poh_out is not None:
            # fail at BOOT, not mid-flight: the poh frame re-wraps the
            # microblock txn section (micro hdr 20 -> poh hdr 42), so
            # the poh link must absorb the worst-case in-frame
            need = ctx.plan["links"][self.in_link]["mtu"] - 20 + 42
            have = ctx.plan["links"][self.poh_link]["mtu"]
            if have < need:
                raise ValueError(
                    f"bank {ctx.tile_name}: forward_payloads needs "
                    f"poh link mtu >= {need}, got {have}")
        self.wave = max(1, int(args.get("wave", 8)))
        self._pending = None           # svm: dispatched, uncommitted wave
        if self.exec_mode in ("svm", "general"):
            from .metrics import HistAccum
            from ..funk.funk import Funk, key32
            from ..ops import cuda_wave
            from ..svm.executor import WaveExecutor
            self._cuda_wave = cuda_wave
            # built for "general" too, as the reference does; only
            # exec="svm" launches it
            self._wx = WaveExecutor(args.get("device", "cuda"))
            # genesis checkpoint: restore the WHOLE boot state
            # (utils/checkpt.funk_restore) into a process funk; the
            # exec fan-out's shm store takes none, as in the reference
            if self.exec_links:
                if args.get("genesis_ckpt"):
                    raise ValueError(
                        f"bank {ctx.tile_name}: genesis_ckpt is "
                        f"process-funk only, not exec fan-out")
                fk = ctx.plan.get("funk") or {}
                if fk.get("backend") != "shm" or "off" not in fk:
                    raise ValueError(
                        f"bank {ctx.tile_name}: exec_links need "
                        f"[funk] backend=\"shm\"")
                from ..funk.shmfunk import WireFunk
                self.funk = WireFunk.from_plan(ctx.wksp, fk)
            elif args.get("genesis_ckpt"):
                from ..utils.checkpt import funk_restore
                with open(args["genesis_ckpt"], "rb") as gf:
                    self.funk = funk_restore(Funk, gf)
            else:
                self.funk = Funk()
            self.xid = None            # published root
            self._next_xid = 1
            # genesis balances: airdropped accounts (tests inject via
            # args), then genesis_synth = N funds the deterministic synth
            # signers (TOML cannot derive pubkeys; the pool wraps mod
            # 16, so each UNIQUE pubkey is funded once)
            for acct_hex, bal in args.get("genesis", {}).items():
                self.funk.rec_write(None, key32(bytes.fromhex(acct_hex)),
                                    int(bal))
            if args.get("genesis_synth"):
                for pub, bal in _synth_genesis(
                        int(args["genesis_synth"])).items():
                    self.funk.rec_write(None, key32(pub), bal)
            if self.exec_mode == "general":
                from ..svm.accdb import AccDb, Account
                from ..svm.programs import TxnExecutor
                # the general executor needs TYPED genesis accounts
                for key, val in list(self.funk.root_items().items()):
                    if isinstance(val, int):
                        self.funk.rec_write(None, key32(key),
                                            Account(lamports=val))
                self.db = AccDb(self.funk)
                self.executor = TxnExecutor(self.db)
            else:
                self._warmup()
            self.tpu_hist = HistAccum()
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]
        self.fanout = None             # exec-family wave scheduler
        if self.exec_links:
            self.fanout = ExecFanout(
                ctx, self.funk, self.exec_links, self.exec_done,
                self.m, on_commit=self._ef_commit,
                redispatch_s=float(args.get("redispatch_s", 2.0)))

    def _warmup(self):
        """One one-transfer wave through the kernel on a scratch funk, so
        the kernel's build, load and first launch happen at boot (a
        failure fails the boot); launches from here on are counted."""
        from ..funk.funk import Funk
        from ..svm.executor import SystemTxn
        scratch = Funk()
        scratch.rec_write(None, bytes(31) + b"\x01", 10)
        wx = self._wx
        disp = wx.dispatch(scratch, None, 1, wx.stage([SystemTxn(
            bytes(31) + b"\x01", bytes(31) + b"\x02", 1, 1)]))
        wx.finalize(scratch, disp)
        self._launch0 = self._cuda_wave.launches["wave_scan"]

    def _parse_payloads(self, frame, txn_cnt):
        """THE microblock frame walker (header 20, u16-framed
        payloads): -> (payloads, parsed ParsedTxns, sha256 mixin over
        first signatures)."""
        from ..protocol.txn import parse_txn
        payloads, parsed, sigs = [], [], []
        off = 20
        for _ in range(txn_cnt):
            (ln,) = struct.unpack_from("<H", frame, off)
            off += 2
            p = bytes(frame[off:off + ln])
            off += ln
            try:
                t = parse_txn(p)
                sigs.append(t.signatures(p)[0])
                payloads.append(p)
                parsed.append(t)
            except Exception:
                self.m["exec_skip"] += 1
        return payloads, parsed, hashlib.sha256(b"".join(sigs)).digest()

    def _wave_order(self, payloads, parsed, xid):
        """Conflict-DAG wave order over the microblock (pack already
        guarantees intra-microblock non-conflict, but the DAG is the
        execution contract: the replay uses the identical staging).
        Resolution runs at the SAME slot the executor will use, so the
        two call sites can never disagree on table activeness."""
        from ..replay.rdisp import ConflictDag
        from ..svm.alut import AlutResolveError, resolve_loaded_keys
        dag = ConflictDag()
        for p, t in zip(payloads, parsed):
            keys = t.account_keys(p)
            flags = [t.is_writable(i) for i in range(t.acct_cnt)]
            if t.version == 0 and t.aluts:
                try:
                    lk, lw = resolve_loaded_keys(
                        self.db, xid, t, slot=self.executor.slot)
                    keys, flags = keys + lk, flags + lw
                except AlutResolveError:
                    pass              # executor fails it cleanly
            dag.add_txn([k for k, w in zip(keys, flags) if w],
                        [k for k, w in zip(keys, flags) if not w])
        for wave in dag.waves():
            for i in wave:
                yield payloads[i], parsed[i]

    def _epoch_boundary(self, xid):
        """Pay EVERY epoch crossed since the persisted paid-through
        marker (quiet epochs with no microblocks included; a restart
        from a snapshot resumes from the marker instead of re-paying):
        first append epoch e's cluster totals to the StakeHistory
        sysvar, so rate-limited warmup and cooldown engage from the
        bank's own state, then pay e's rewards under the parent
        blockhash sha256(b"epoch-%d" % (e + 1))."""
        ep = self.slot // self.slots_per_epoch
        if ep <= 0:
            return
        from ..flamenco import rewards, stakes
        start = self._rewards_epoch
        if start is None:
            start = rewards.paid_through(self.funk, xid)
        if ep > start:
            for e in range(start, ep):
                stakes.update_stake_history(self.funk, xid, e)
                s = rewards.distribute_epoch_rewards(
                    self.funk, xid, e, None, self.slots_per_epoch,
                    hashlib.sha256(b"epoch-%d" % (e + 1)).digest())
                self.m["rewards_paid"] += s["paid"]
            rewards.mark_paid_through(self.funk, xid, ep)
        self._rewards_epoch = ep

    def _wave_general(self, frames):
        """The FULL host SVM a microblock (inherently host-serial per
        txn), with the wave's poh frames + completions flushed as batch
        publishes after the execution loop."""
        poh_frames = []
        for frame, txn_cnt, mb_id in frames:
            if not txn_cnt:
                continue
            payloads, parsed, mixin = self._parse_payloads(frame, txn_cnt)
            if payloads:
                t0 = time.perf_counter_ns()
                new_xid = self._next_xid
                self._next_xid += 1
                self.funk.txn_prepare(None, new_xid)
                ok = fail = 0
                try:
                    # the Clock view executes at the microblock's slot;
                    # sysvar accounts materialize into this fork
                    self.executor.begin_slot(
                        new_xid, self.slot,
                        slots_per_epoch=self.slots_per_epoch)
                    self._epoch_boundary(new_xid)
                    for p, _ in self._wave_order(payloads, parsed,
                                                 new_xid):
                        if self.executor.execute(new_xid, p).status \
                                == "ok":
                            ok += 1
                        else:
                            fail += 1
                    self.funk.txn_publish(new_xid)
                except Exception:
                    self.funk.txn_cancel(new_xid)
                    raise
                self.m["transfers"] += ok
                self.m["exec_fail"] += fail
                self.tpu_hist.add(time.perf_counter_ns() - t0)
            if self.poh_out is not None:
                blob = frame[20:] if self.fwd_payloads else b""
                poh_frames.append(
                    (mb_id, struct.pack("<QH", mb_id, txn_cnt)
                     + mixin + blob))
        self._flush_wave(poh_frames, [mb_id for _, _, mb_id in frames])

    def _parse_transfers(self, frame, txn_cnt):
        """Microblock frame -> (SystemTxn list — one per system-program
        Transfer instruction, in instruction order, fee charged on each
        txn's first only —, sha256 mixin over concatenated first
        signatures)."""
        from ..pack.cost import SYSTEM_PROGRAM_ID
        from ..pack.scheduler import FEE_PER_SIGNATURE
        from ..protocol.txn import parse_txn
        from ..svm.executor import SystemTxn
        txns, sigs = [], []
        off = 20
        for _ in range(txn_cnt):
            (ln,) = struct.unpack_from("<H", frame, off)
            off += 2
            payload = bytes(frame[off:off + ln])
            off += ln
            try:
                t = parse_txn(payload)
            except Exception:
                self.m["exec_skip"] += 1
                continue
            sigs.append(t.signatures(payload)[0])
            keys = t.account_keys(payload)
            matched = 0
            for ins in t.instrs:
                data = payload[ins.data_off:ins.data_off + ins.data_sz]
                # system-program Transfer: u32 discriminant 2 + u64
                # lamports (fd_system_program.c transfer instruction);
                # every transfer instruction executes, fee once per txn
                if (keys[ins.prog_idx] == SYSTEM_PROGRAM_ID
                        and len(data) == 12
                        and data[:4] == b"\x02\x00\x00\x00"
                        and len(ins.acct_idxs) >= 2):
                    amt = int.from_bytes(data[4:12], "little")
                    txns.append(SystemTxn(
                        src=keys[ins.acct_idxs[0]],
                        dst=keys[ins.acct_idxs[1]], amount=amt,
                        fee=0 if matched
                        else FEE_PER_SIGNATURE * t.sig_cnt))
                    matched += 1
            if not matched:
                self.m["exec_skip"] += 1
        mixin = hashlib.sha256(b"".join(sigs)).digest()
        return txns, mixin

    def poll_once(self) -> int:
        if self.exec_links:
            return self._poll_exec_family()
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, self.wave, self.mtu)
        self.m["overruns"] += ovr
        if not n:
            # drain-on-idle: a dispatched wave always retires — queued
            # completions never wait on more microblocks arriving
            if self._pending is not None:
                self._finalize_wave()
            return 0
        frames = []
        for i in range(n):
            frame = bytes(buf[i, :sizes[i]])
            _bank, txn_cnt, mb_id, slot = struct.unpack_from(
                "<HHQQ", frame, 0)
            self.slot = max(self.slot, slot)
            self.m["txns"] += txn_cnt
            self.m["microblocks"] += 1
            frames.append((frame, txn_cnt, mb_id))
        if self.exec_mode == "svm":
            self._wave_svm(frames)
        elif self.exec_mode == "general":
            self._wave_general(frames)
        else:
            self._flush_wave([], [mb_id for _, _, mb_id in frames])
        return n

    def _wave_svm(self, frames):
        """Stage -> (retire previous) -> dispatch: the wave's packed
        conflict tables are balance-independent, so their device
        transfer launches FIRST and overlaps the previous wave's
        compute; that wave then commits (and its completions publish)
        before this wave's balances are read — the rotating-stage
        pipeline, with serial fiction intact."""
        recs, txns = [], []
        for frame, txn_cnt, mb_id in frames:
            if txn_cnt:
                t, mixin = self._parse_transfers(frame, txn_cnt)
            else:
                t, mixin = [], hashlib.sha256(b"").digest()
            recs.append((frame, txn_cnt, mb_id, mixin))
            txns.extend(t)
        t0 = time.perf_counter_ns()
        staged = self._wx.stage(txns) if txns else None
        span = time.perf_counter_ns() - t0
        if self._pending is not None:
            self._finalize_wave()
        disp = None
        if staged is not None:
            new_xid = self._next_xid
            self._next_xid += 1
            t0 = time.perf_counter_ns()
            try:
                disp = self._wx.dispatch(self.funk, self.xid, new_xid,
                                         staged)
            except Exception:
                self.funk.txn_cancel(new_xid)
                raise
            # the dispatch span: staging and dispatch, without the
            # previous wave's finalize between them
            self.tpu_hist.add(span + time.perf_counter_ns() - t0)
        self._pending = (disp, recs)

    def _finalize_wave(self):
        """Wait for the pending wave's results, commit its funk fork,
        then flush its poh mixin frames + completion frags as one
        publish_batch per link."""
        from ..svm.executor import STATUS_OK
        disp, recs = self._pending
        self._pending = None
        if disp is not None:
            t0 = time.perf_counter_ns()
            try:
                st = self._wx.finalize(self.funk, disp)
                self.funk.txn_publish(disp.xid)
                self.xid = None   # published into root
            except Exception:
                self.funk.txn_cancel(disp.xid)
                raise
            self.tpu_hist.add(time.perf_counter_ns() - t0)
            ok = sum(1 for s in st if s == STATUS_OK)
            self.m["transfers"] += ok
            self.m["exec_fail"] += len(st) - ok
        poh_frames = []
        if self.poh_out is not None:
            for frame, txn_cnt, mb_id, mixin in recs:
                if not txn_cnt:
                    continue
                # forward_payloads: carry the microblock's txn section
                # so poh entries carry the real block content
                blob = frame[20:] if self.fwd_payloads else b""
                poh_frames.append(
                    (mb_id, struct.pack("<QH", mb_id, txn_cnt)
                     + mixin + blob))
        self._flush_wave(poh_frames, [r[2] for r in recs])

    def _poll_exec_family(self) -> int:
        """Exec fan-out scheduler loop: drain completion frags, then —
        only with NO wave outstanding — gather the next wave and
        dispatch it (ExecFanout keeps waves serial, so cross-wave
        conflicts need no tracking at all)."""
        work = self.fanout.poll()
        if self.fanout.busy:
            return work
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, self.wave, self.mtu)
        self.m["overruns"] += ovr
        if not n:
            return work
        recs, txns = [], []
        for i in range(n):
            frame = bytes(buf[i, :sizes[i]])
            _bank, txn_cnt, mb_id, slot = struct.unpack_from(
                "<HHQQ", frame, 0)
            self.slot = max(self.slot, slot)
            self.m["txns"] += txn_cnt
            self.m["microblocks"] += 1
            if txn_cnt:
                t, mixin = self._parse_transfers(frame, txn_cnt)
            else:
                t, mixin = [], hashlib.sha256(b"").digest()
            recs.append((frame, txn_cnt, mb_id, mixin))
            txns.extend(t)
        self.fanout.dispatch(txns, tag=recs)
        return work + n

    def _ef_commit(self, recs, xid, ok, fail):
        """Fan-out wave complete: publish the fork, then flush the poh
        mixin frames + completion frags in the original microblock
        order (commit ordering stays with the bank, exactly the
        in-process path's contract)."""
        if xid is not None:
            self.funk.txn_publish(xid)
            self.m["transfers"] += ok
            self.m["exec_fail"] += fail
        poh_frames = []
        if self.poh_out is not None:
            for frame, txn_cnt, mb_id, mixin in recs:
                if not txn_cnt:
                    continue
                blob = frame[20:] if self.fwd_payloads else b""
                poh_frames.append(
                    (mb_id, struct.pack("<QH", mb_id, txn_cnt)
                     + mixin + blob))
        self._flush_wave(poh_frames, [r[2] for r in recs])

    def _flush_wave(self, poh_frames, done_ids):
        cnc = getattr(self.ctx, "cnc", None)
        if poh_frames and self.poh_out is not None:
            publish_wave(self.poh_out, self.poh_fseqs, poh_frames,
                         cnc=cnc)
        if done_ids:
            publish_wave(
                self.out, self.out_fseqs,
                [(mb, struct.pack("<Q", mb)) for mb in done_ids],
                cnc=cnc)

    def on_halt(self):
        # a wave already dispatched must still commit and publish its
        # completions (the verify tile's flush contract)
        if self._pending is not None:
            self._finalize_wave()
        if self.fanout is not None and self.fanout.busy:
            # bounded drain then cancel (ExecFanout.halt): exec tiles
            # are halting too, so after the window the fork is dropped
            # rather than wedging the halt — no poh frame for a wave
            # that never completed, no partial commits in the store
            self.fanout.halt()
        if self.final_ckpt:
            import os

            from ..utils.checkpt import funk_checkpt
            tmp = f"{self.final_ckpt}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                funk_checkpt(self.funk, f, compress=False)
            os.replace(tmp, self.final_ckpt)

    def housekeeping(self):
        knobs = getattr(self.ctx, "knobs", None)
        if knobs is not None:
            v = knobs.get("bank_wave")
            if v is not None:
                self.wave = max(1, v)

    def in_seqs(self):
        s = {self.in_link: self.seq}
        if self.fanout is not None:
            s.update(self.fanout.done_seq)
        return s

    def metrics_items(self):
        m = dict(self.m)
        if self.exec_mode == "svm":
            m["wave_launches"] = (self._cuda_wave.launches["wave_scan"]
                                  - self._launch0)
        return m


@register("exec")
class ExecAdapter:
    """Exec tile (ref: src/discof/exec/fd_exec_tile.c): one shard of the
    bank's execution fan-out. Consumes the bank's conflict-group dispatch
    frames, executes each through the WaveExecutor (one launch of the
    wave-scan kernel a frame, on the card unless `device` says "cpu")
    against the shm funk store AT THE FORK THE BANK PREPARED — dispatch
    reads balances at the frame's xid itself, so a split group's later
    frames see the earlier frames' commits (WireFunk's txn_prepare is
    idempotent, which is what lets the WaveExecutor's
    stage->dispatch->finalize seam run here unchanged) — and publishes
    one completion frag per frame. A frame whose fork the bank already
    cancelled (timeout redispatch) is abandoned with NO completion and
    counted in `stale_xid`: the retry under the fresh fork supersedes
    it.

    Like the bank, the tile boots by running one one-transfer wave
    through the kernel on a scratch in-process funk, so a kernel that
    does not build or launch fails the tile's boot, and it counts the
    launches it makes after that in its `wave_launches` metric. Its
    housekeeping reads the fdtune `exec_dispatch` knob into `batch`.

    args: batch (dispatch frames gathered per poll), device ("cuda" |
    "cpu")."""

    METRICS = ["frames", "txns", "ok", "fail", "stale_xid",
               "overruns", "backpressure", "wave_launches"]

    def __init__(self, ctx, args):
        from ..funk.shmfunk import WireFunk
        from ..ops import cuda_wave
        from ..svm.executor import WaveExecutor
        self.ctx = ctx
        if len(ctx.in_rings) != 1:
            raise ValueError(f"exec tile {ctx.tile_name}: one in link")
        self.in_link = next(iter(ctx.in_rings))
        self.ring = ctx.in_rings[self.in_link]
        self.out = _single(ctx.out_rings, "out link", ctx.tile_name)
        self.out_fseqs = _single(ctx.out_fseqs, "out link",
                                 ctx.tile_name)
        self.batch = max(1, int(args.get("batch", 8)))
        fk = ctx.plan.get("funk") or {}
        if fk.get("backend") != "shm" or "off" not in fk:
            raise ValueError(
                f"exec {ctx.tile_name}: needs [funk] backend=\"shm\"")
        self.funk = WireFunk.from_plan(ctx.wksp, fk)
        self._cuda_wave = cuda_wave
        self._wx = WaveExecutor(args.get("device", "cuda"))
        self.m = {k: 0 for k in self.METRICS}
        self._warmup()
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]

    def _warmup(self):
        """The bank's boot wave (BankAdapter._warmup): one one-transfer
        wave on a scratch in-process funk; launches from here on are
        counted."""
        from ..funk.funk import Funk
        from ..svm.executor import SystemTxn
        scratch = Funk()
        scratch.rec_write(None, bytes(31) + b"\x01", 10)
        wx = self._wx
        disp = wx.dispatch(scratch, None, 1, wx.stage([SystemTxn(
            bytes(31) + b"\x01", bytes(31) + b"\x02", 1, 1)]))
        wx.finalize(scratch, disp)
        self._launch0 = self._cuda_wave.launches["wave_scan"]

    def poll_once(self) -> int:
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, self.batch, self.mtu)
        self.m["overruns"] += ovr
        if not n:
            return 0
        from ..funk import FunkTxnError
        from ..svm.executor import STATUS_OK, SystemTxn
        comps = []
        for i in range(n):
            frame = bytes(buf[i, :sizes[i]])
            wave_seq, xid, cnt = _EXEC_HDR.unpack_from(frame, 0)
            off = _EXEC_HDR.size
            txns = []
            for _ in range(cnt):
                amt, fee = _EXEC_TXN.unpack_from(frame, off + 64)
                txns.append(SystemTxn(
                    src=frame[off:off + 32],
                    dst=frame[off + 32:off + 64],
                    amount=amt, fee=fee))
                off += _EXEC_TXN_SZ
            self.m["frames"] += 1
            self.m["txns"] += cnt
            try:
                staged = self._wx.stage(txns)
                disp = self._wx.dispatch(self.funk, xid, xid, staged)
                st = self._wx.finalize(self.funk, disp)
            except (FunkTxnError, KeyError, MemoryError):
                self.m["stale_xid"] += 1
                continue
            ok = sum(1 for s in st if s == STATUS_OK)
            self.m["ok"] += ok
            self.m["fail"] += len(st) - ok
            comps.append((wave_seq,
                          _EXEC_DONE.pack(wave_seq, ok, len(st) - ok)))
        if comps:
            publish_wave(self.out, self.out_fseqs, comps,
                         cnc=getattr(self.ctx, "cnc", None))
        return n

    def housekeeping(self):
        knobs = getattr(self.ctx, "knobs", None)
        if knobs is not None:
            v = knobs.get("exec_dispatch")
            if v is not None:
                # per-poll gather depth only — frames already gathered
                # this poll finish, so shrinking takes one poll
                self.batch = max(1, v)

    def in_seqs(self):
        return {self.in_link: self.seq}

    def metrics_items(self):
        return self.m | {"wave_launches": (
            self._cuda_wave.launches["wave_scan"] - self._launch0)}


@register("resolv")
class ResolvAdapter:
    """Resolution stage ahead of pack (ref: src/discof/resolv/
    fd_resolv_tile.c): parse each txn once, resolve v0 address-table
    loads against the shm account store, drop txns whose fee payer
    can't cover the signature fee, and ship RESOLVED frames so pack
    never re-parses and never needs account-db access (pack side:
    resolved_in + pack/scheduler.py meta_from_resolved).

    Without a shm [funk] section the tile still runs — legacy txns
    resolve statically from their own account keys; v0 txns with
    table loads are refused (alut_fail), exactly meta_from_payload's
    rule — and the fee-payer gate is off (no store to read).

    args: batch, fee_payer_check (default on when the store is
    present)."""

    METRICS = ["rx", "resolved", "parse_fail", "alut_fail",
               "fee_fail", "oversz", "overruns", "backpressure"]

    def __init__(self, ctx, args):
        self.ctx = ctx
        if len(ctx.in_rings) != 1:
            raise ValueError(
                f"resolv tile {ctx.tile_name}: one in link")
        self.in_link = next(iter(ctx.in_rings))
        self.ring = ctx.in_rings[self.in_link]
        out = [ln for ln in ctx.out_rings]
        if len(out) != 1:
            raise ValueError(
                f"resolv tile {ctx.tile_name}: one out link")
        self.out_link = out[0]
        self.out = ctx.out_rings[self.out_link]
        self.out_fseqs = ctx.out_fseqs[self.out_link]
        self.batch = max(1, int(args.get("batch", 64)))
        self.db = None
        fk = ctx.plan.get("funk") or {}
        if fk.get("backend") == "shm" and "off" in fk:
            from ..funk.shmfunk import WireFunk
            from ..svm.accdb import AccDb
            self.db = AccDb(WireFunk.from_plan(ctx.wksp, fk))
        self.fee_check = bool(args.get("fee_payer_check",
                                       self.db is not None))
        if self.fee_check and self.db is None:
            raise ValueError(
                f"resolv {ctx.tile_name}: fee_payer_check needs "
                f"[funk] backend=\"shm\"")
        self.m = {k: 0 for k in self.METRICS}
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]
        self.out_mtu = ctx.plan["links"][self.out_link]["mtu"]

    def _resolve(self, payload):
        """payload -> RESOLVED frame bytes, or None (counted drop).
        The meta_from_payload cost/reward model with the v0 refusal
        replaced by REAL table resolution against the store."""
        from ..pack.cost import CostError
        from ..pack.scheduler import (FEE_PER_SIGNATURE, TxnMeta,
                                      serialize_resolved,
                                      txn_cost_and_reward)
        from ..protocol.txn import parse_txn
        from ..svm.alut import AlutResolveError, resolve_loaded_keys
        try:
            t = parse_txn(payload)
        except Exception:
            self.m["parse_fail"] += 1
            return None
        keys = t.account_keys(payload)
        flags = [t.is_writable(i) for i in range(t.acct_cnt)]
        if t.version == 0 and t.aluts:
            if self.db is None:
                self.m["alut_fail"] += 1
                return None
            try:
                lk, lw = resolve_loaded_keys(self.db, None, t,
                                             slot=0)
            except AlutResolveError:
                self.m["alut_fail"] += 1
                return None
            keys, flags = keys + lk, flags + list(lw)
        try:
            cost, reward, vote = txn_cost_and_reward(t, payload)
        except CostError:
            self.m["parse_fail"] += 1
            return None
        if self.fee_check:
            payer = self.db.peek(None, keys[0])
            fee = FEE_PER_SIGNATURE * t.sig_cnt
            if payer is None or payer.lamports < fee:
                self.m["fee_fail"] += 1
                return None
        meta = TxnMeta(
            payload, t, reward, cost,
            tuple(k for k, w in zip(keys, flags) if w),
            tuple(k for k, w in zip(keys, flags) if not w),
            is_vote=vote)
        return serialize_resolved(meta)

    def poll_once(self) -> int:
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, self.batch, self.mtu)
        self.m["overruns"] += ovr
        if not n:
            return 0
        frames = []
        for i in range(n):
            self.m["rx"] += 1
            out = self._resolve(bytes(buf[i, :sizes[i]]))
            if out is None:
                continue
            if len(out) > self.out_mtu:
                self.m["oversz"] += 1
                continue
            self.m["resolved"] += 1
            frames.append((int(sigs[i]), out))
        if frames:
            publish_wave(self.out, self.out_fseqs, frames,
                         cnc=getattr(self.ctx, "cnc", None))
        return n

    def in_seqs(self):
        return {self.in_link: self.seq}

    def metrics_items(self):
        return dict(self.m)


@register("poh")
class PohAdapter:
    """Proof-of-History tile (ref: src/discof/poh/fd_poh.h:4-31): owns
    the hash chain; mixes executed microblocks (from bank tiles) into
    it as record entries, emits tick entries on schedule, and declares
    slot boundaries by TICK COUNT — the pack tile ends its block on the
    slot frag, not a wall clock. Chain generation is host-side
    (inherently sequential).

    Batched mixin: the gathered wave of bank microblocks mixes into the
    chain as hash-chain RUNS (one host_poh_mixin_chain call per run
    between tick boundaries, byte-identical to the sequential fold), and
    every entry/slot frag the wave produced flushes as ONE credit-gated
    publish_batch per link.

    Entry frag wire: u64 slot | u32 tick | u32 num_hashes |
    u8 has_mixin | prev 32 | hash 32 | mixin 32 | u8 flags
    (bit0 = slot_complete, set on the slot's final tick entry) |
    u16 txn_cnt | txn section (u16 len | payload)* — the txn section
    is whatever the bank forwarded (forward_payloads).
    Slot frag wire (slot_link): u64 completed_slot.

    args: hashes_per_tick, ticks_per_slot, seed (hex, 32B),
    slot_link (optional out link to pack), entry link = remaining out.
    """

    METRICS = ["mixins", "ticks", "slots", "entries", "overruns",
               "backpressure"]

    def __init__(self, ctx, args):
        from ..ops.poh import (host_poh_append, host_poh_mixin,
                               host_poh_mixin_chain)
        self._append = host_poh_append
        self._mixin = host_poh_mixin
        self._mixin_chain = host_poh_mixin_chain
        self.ctx = ctx
        self.hashes_per_tick = int(args.get("hashes_per_tick", 64))
        self.ticks_per_slot = int(args.get("ticks_per_slot", 8))
        self.state = bytes.fromhex(args["seed"]) if "seed" in args \
            else bytes(32)
        self.slot_link = args.get("slot_link")
        if self.slot_link:
            self.slot_out = ctx.out_rings[self.slot_link]
            self.slot_fseqs = ctx.out_fseqs[self.slot_link]
            ent = [ln for ln in ctx.out_rings if ln != self.slot_link]
            if len(ent) != 1:
                raise ValueError(f"poh {ctx.tile_name}: expected one "
                                 f"entry link, got {ent}")
            self.entry_out = ctx.out_rings[ent[0]]
            self.entry_fseqs = ctx.out_fseqs[ent[0]]
        else:
            self.slot_out = None
            self.entry_out = _single(ctx.out_rings, "out link",
                                     ctx.tile_name)
            self.entry_fseqs = _single(ctx.out_fseqs, "out link",
                                       ctx.tile_name)
        self.seqs = ctx.in_seqs0()
        self.mtu = max((ctx.plan["links"][ln]["mtu"]
                        for ln in ctx.in_rings), default=64)
        # entry frames re-wrap the bank frame's txn section (bank hdr
        # 42 -> entry hdr 116); catch an undersized entry link at boot
        ent_ln = next(ln for ln, r in ctx.out_rings.items()
                      if r is self.entry_out)
        ent_mtu = ctx.plan["links"][ent_ln]["mtu"]
        if ctx.in_rings and ent_mtu < self.mtu - 42 + 116:
            raise ValueError(
                f"poh {ctx.tile_name}: entry link mtu {ent_mtu} < "
                f"worst-case entry frame {self.mtu - 42 + 116}")
        self.slot = 0
        self.tick_in_slot = 0
        self.hashes_in_tick = 0
        self.entry_idx = 0
        # wave staging: entry/slot frames built while walking a
        # gathered wave, flushed as one publish_batch per link
        self._pend_entries: list[tuple[int, bytes]] = []
        self._pend_slots: list[int] = []
        self.m = {k: 0 for k in self.METRICS}

    def _emit_entry(self, num_hashes: int, prev: bytes,
                    mixin: bytes | None, txn_blob: bytes = b"",
                    txn_cnt: int = 0, slot_done: bool = False):
        frame = struct.pack("<QII B", self.slot, self.tick_in_slot,
                            num_hashes, 1 if mixin else 0)
        frame += prev + self.state + (mixin or bytes(32))
        frame += bytes([1 if slot_done else 0]) \
            + struct.pack("<H", txn_cnt) + txn_blob
        self._pend_entries.append((self.entry_idx, frame))
        self.entry_idx += 1
        self.m["entries"] += 1

    def _flush_pending(self):
        cnc = getattr(self.ctx, "cnc", None)
        if self._pend_entries:
            frames, self._pend_entries = self._pend_entries, []

            def bp():
                self.m["backpressure"] += 1
            publish_wave(self.entry_out, self.entry_fseqs, frames,
                         cnc=cnc, on_stall=bp)
        if self._pend_slots and self.slot_out is not None:
            slots, self._pend_slots = self._pend_slots, []
            publish_wave(
                self.slot_out, self.slot_fseqs,
                [(s, struct.pack("<Q", s)) for s in slots], cnc=cnc)

    def poll_once(self) -> int:
        total = 0
        # 1) mix in executed microblocks (one hash consumed per record;
        # fd_poh mixin semantics, src/ballet/poh/fd_poh.c): maximal runs
        # between tick boundaries hash as ONE chain call, and every
        # frame the wave produced ships as one publish_batch per link
        for ln, ring in self.ctx.in_rings.items():
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], 16, self.mtu)
            self.m["overruns"] += ovr
            if not n:
                continue
            mixins = [bytes(buf[i, 10:42]) for i in range(n)]
            cnts = [struct.unpack_from("<H", buf[i], 8)[0]
                    for i in range(n)]
            blobs = [bytes(buf[i, 42:sizes[i]]) for i in range(n)]
            i = 0
            while i < n:
                # a record must fit before the tick boundary (at most
                # one tick fires per record position)
                if self.hashes_in_tick + 1 >= self.hashes_per_tick:
                    self._tick()
                take = min(max(1, self.hashes_per_tick
                               - self.hashes_in_tick - 1), n - i)
                states = self._mixin_chain(self.state,
                                           mixins[i:i + take])
                for j in range(take):
                    prev = self.state
                    self.state = states[j]
                    self.hashes_in_tick += 1
                    blob = blobs[i + j]
                    self._emit_entry(1, prev, mixins[i + j],
                                     txn_blob=blob,
                                     txn_cnt=cnts[i + j] if blob else 0)
                    self.m["mixins"] += 1
                i += take
            total += n
        if self._pend_entries or self._pend_slots:
            self._flush_pending()
        return total

    def _tick(self):
        remaining = self.hashes_per_tick - self.hashes_in_tick
        prev = self.state
        self.state = self._append(prev, remaining)
        self._emit_entry(
            remaining, prev, None,
            slot_done=self.tick_in_slot + 1 >= self.ticks_per_slot)
        self.hashes_in_tick = 0
        self.tick_in_slot += 1
        self.m["ticks"] += 1
        if self.tick_in_slot >= self.ticks_per_slot:
            if self.slot_out is not None:
                self._pend_slots.append(self.slot)
            self.slot += 1
            self.tick_in_slot = 0
            self.m["slots"] += 1

    def housekeeping(self):
        # tick cadence: one tick per housekeeping interval (the jittered
        # stem timer stands in for the tick clock)
        self._tick()
        self._flush_pending()

    def on_halt(self):
        self._flush_pending()    # staged frames must not die with us

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return dict(self.m)


@register("shred")
class ShredAdapter:
    """Turbine shred tile (ref: src/disco/shred/fd_shred_tile.c:6-60 —
    one tile serves both directions).

    mode="leader": in link = poh entries; shreds entry batches into
    signed merkle FEC sets (keyguard LEADER role via req/resp links)
    and transmits each shred to its stake-weighted turbine first hop
    over UDP. args: cluster = [{pubkey_hex, stake, addr "host:port"}],
    identity_hex, req/resp (keyguard links), optional out link
    "shreds" mirror + "batches" witness link, flush_bytes, fanout,
    shred_version, drop_slot_every (the fault seam: every Nth slot's
    shreds are withheld from turbine and counted in `dropped`, still
    mirrored, so a non-leader must repair them).

    mode="recover": in links = raw shred wires (turbine ingest and
    repair responses feed the same resolver); FEC-resolves, stores,
    reassembles ordered slices on the out link. args:
    leader_pubkey_hex; with cluster + identity_hex it also retransmits
    to its turbine children the shreds of `turbine_in` (default: the
    first in link)."""

    METRICS = ["entries", "batches", "fec_sets", "data_shreds",
               "parity_shreds", "sent", "no_dest", "sign_fail",
               "slots", "shreds", "fecs", "slices", "slots_done",
               "parse_fail", "retransmitted", "dropped", "overruns"]

    def __init__(self, ctx, args):
        self.ctx = ctx
        self.mode = args.get("mode", "leader")
        self._ovr = 0
        if self.mode == "leader":
            self._init_leader(ctx, args)
        elif self.mode == "recover":
            self._init_recover(ctx, args)
        else:
            raise ValueError(f"shred {ctx.tile_name}: mode {self.mode!r}")

    @staticmethod
    def _cluster(args):
        from ..shred.shred_dest import ClusterNode
        return [ClusterNode(bytes.fromhex(n["pubkey_hex"]),
                            int(n["stake"]),
                            (n["addr"].rsplit(":", 1)[0],
                             int(n["addr"].rsplit(":", 1)[1])))
                for n in args.get("cluster", [])]

    def _init_leader(self, ctx, args):
        import socket

        from ..keyguard import KeyguardClient
        from ..tiles import shred as shredmod
        ins = [ln for ln in ctx.in_rings if ln != args["resp"]]
        if len(ins) != 1:
            raise ValueError(f"shred {ctx.tile_name}: expected one entry "
                             f"link besides {args['resp']}, got {ins}")
        self.in_link = ins[0]
        kg = KeyguardClient(ctx.out_rings[args["req"]],
                            ctx.in_rings[args["resp"]],
                            req_fseqs=ctx.out_fseqs[args["req"]],
                            cnc=getattr(ctx, "cnc", None))

        def sign_fn(root):
            sig = kg.sign(root)
            if sig is None:
                self.core.metrics["sign_fail"] += 1
                raise RuntimeError("keyguard refused shred root")
            return sig

        self._kg = kg
        aux = [ln for ln in ctx.out_rings if ln != args["req"]]
        shreds_ln = args.get("shreds_link")
        batch_ln = args.get("batches_link")
        if set(aux) != {ln for ln in (shreds_ln, batch_ln) if ln}:
            raise ValueError(f"shred {ctx.tile_name}: out links {aux} are "
                             f"not shreds_link {shreds_ln!r} and "
                             f"batches_link {batch_ln!r}")
        self.core = shredmod.ShredLeaderCore(
            sign_fn, bytes.fromhex(args["identity_hex"]),
            self._cluster(args),
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM),
            out_ring=ctx.out_rings.get(shreds_ln),
            out_fseqs=ctx.out_fseqs.get(shreds_ln),
            batch_out=ctx.out_rings.get(batch_ln),
            batch_fseqs=ctx.out_fseqs.get(batch_ln),
            shred_version=int(args.get("shred_version", 0)),
            fanout=int(args.get("fanout", 200)),
            flush_bytes=int(args.get("flush_bytes", 31840)),
            drop_slot_every=int(args.get("drop_slot_every", 0)),
            cnc=getattr(ctx, "cnc", None))
        self.ring = ctx.in_rings[self.in_link]
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]
        self.seq = ctx.in_seq0.get(self.in_link, 0)

    def _init_recover(self, ctx, args):
        import socket

        from ..tiles import shred as shredmod
        self.in_links = list(ctx.in_rings)
        dest = identity = rt_sock = None
        if args.get("cluster") and args.get("identity_hex"):
            identity = bytes.fromhex(args["identity_hex"])
            dest = shredmod.ShredDest(self._cluster(args), identity,
                                      fanout=int(args.get("fanout", 200)))
            rt_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.core = shredmod.ShredRecoverCore(
            bytes.fromhex(args["leader_pubkey_hex"]),
            _single(ctx.out_rings, "out link", ctx.tile_name),
            _single(ctx.out_fseqs, "out link", ctx.tile_name),
            dest=dest, identity=identity, sock=rt_sock)
        # repair responses must NOT re-enter turbine: only the turbine
        # ingest link retransmits
        self.turbine_in = args.get("turbine_in", self.in_links[0])
        self.seqs = {ln: ctx.in_seq0.get(ln, 0) for ln in self.in_links}
        self.mtus = {ln: ctx.plan["links"][ln]["mtu"]
                     for ln in self.in_links}

    def poll_once(self) -> int:
        if self.mode == "recover":
            return self._poll_recover()
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, 16, self.mtu)
        self._ovr += ovr
        _trace_consume(self.ctx, self.in_link, sigs, n)
        for i in range(n):
            try:
                self.core.on_entry(bytes(buf[i, :sizes[i]]))
            except SignHalted:
                break   # halting: what is left of the poll is dropped
        # the wave's mirror wires ship as one batched publish (the core
        # buffers per entry, the adapter publishes per poll)
        self.core.flush_egress()
        return n

    def _poll_recover(self) -> int:
        total = 0
        for ln in self.in_links:
            n, self.seqs[ln], buf, sizes, sigs, ovr = \
                self.ctx.in_rings[ln].gather(self.seqs[ln], 16,
                                             self.mtus[ln])
            self._ovr += ovr
            _trace_consume(self.ctx, ln, sigs, n)
            rt = ln == self.turbine_in
            for i in range(n):
                self.core.on_shred(bytes(buf[i, :sizes[i]]), retransmit=rt)
            total += n
        return total

    def in_seqs(self):
        if self.mode == "recover":
            return dict(self.seqs)
        # the response link reports the keyguard client's position
        return {ln: self.seq if ln == self.in_link else self._kg.resp_seq
                for ln in self.ctx.in_rings}

    def on_halt(self):
        if self.mode == "leader":
            self.core.flush_egress()   # buffered wires must not die

    def metrics_items(self):
        return {k: self.core.metrics.get(k, 0) for k in self.METRICS
                if k != "overruns"} | {"overruns": self._ovr}


@register("replay")
class ReplayAdapter:
    """Replay tile (ref: src/discof/replay/fd_replay_tile.c:77-95):
    consumes reassembled slices, re-verifies PoH with the SHA-256
    kernel's `poh_verify`, stages txns through the conflict DAG,
    executes them on the host TxnExecutor, folds each slot's account
    delta into the bank-hash lattice with the BLAKE3 kernel's `lthash`,
    and notifies tower per completed block (the frame's block id is the
    slot's bank hash). `expected` pins the leader's per-slot bank
    hashes: a mismatch is a divergence VERDICT (metric + loud tile
    FAIL), never a silent wrong state.

    Follower fan-out: with `exec_links`/`exec_done` the slot's transfers
    execute over the exec tile family against the shm funk store, the
    SAME ExecFanout engine the leader bank uses, so the shards replay a
    slot in parallel with exactly-once commits across an exec-shard
    crash.

    args: genesis ({pubkey_hex: lamports}), genesis_synth,
    hashes_per_tick, verify_poh, redispatch_s (all three default from
    the plan's [replay] section), slots_per_epoch, expected ({slot:
    bank_hash_hex}), exec_links/exec_done (ordered per-shard dispatch
    and completion links), device ("cuda" | "cpu"), wait_restore,
    snapshot_path, snapshot_every, snapshot_compress (the last three
    default from the plan's [snapshot] section).

    Cold start: with `wait_restore` the tile buffers slices and polls
    the store root for snapin's restore marker each poll; when it lands
    the core folds the whole restored store on the device (its span in
    the tpu histogram; `restore_read_us`, `restore_fold_us` and
    `restore_gate_us` split it) and replays the tail from the snapshot
    slot."""

    METRICS = ["slices", "slots_replayed", "entries", "txns", "exec_ok",
               "exec_fail", "poh_fail", "buffered", "waves",
               "parse_fail", "exec_skip", "exec_waves",
               "exec_redispatch", "divergent_slot", "snapshots",
               "restore_slot", "behind", "overruns", "poh_launches",
               "lthash_launches", "restore_read_us", "restore_fold_us",
               "restore_gate_us"]

    def __init__(self, ctx, args):
        from .metrics import HistAccum
        from ..ops import cuda_blake3, cuda_sha256
        from ..tiles.replay import ReplayCore
        self.ctx = ctx
        self.exec_links = list(args.get("exec_links") or [])
        self.exec_done = list(args.get("exec_done") or [])
        non_done = [ln for ln in ctx.in_rings if ln not in self.exec_done]
        if len(non_done) != 1:
            raise ValueError(
                f"replay tile {ctx.tile_name}: exactly one slice in "
                f"link, got {non_done}")
        self.in_link = non_done[0]
        self.ring = ctx.in_rings[self.in_link]
        genesis = {bytes.fromhex(k): int(v)
                   for k, v in args.get("genesis", {}).items()}
        if args.get("genesis_synth"):
            genesis.update(_synth_genesis(int(args["genesis_synth"])))
        outs = {ln: r for ln, r in ctx.out_rings.items()
                if ln not in self.exec_links}
        out_fseqs = {ln: f for ln, f in ctx.out_fseqs.items()
                     if ln not in self.exec_links}
        rp = ctx.plan.get("replay") or {}
        sp = ctx.plan.get("snapshot") or {}
        funk = fanout = None
        if self.exec_links:
            fk = ctx.plan.get("funk") or {}
            if fk.get("backend") != "shm" or "off" not in fk:
                raise ValueError(
                    f"replay {ctx.tile_name}: exec_links need "
                    f"[funk] backend=\"shm\"")
            from ..funk.shmfunk import WireFunk
            funk = WireFunk.from_plan(ctx.wksp, fk)
            fanout = ExecFanout(
                ctx, funk, self.exec_links, self.exec_done, m={},
                redispatch_s=float(args.get(
                    "redispatch_s", rp.get("redispatch_s", 2.0))))
        expected = {int(s): bytes.fromhex(h)
                    for s, h in (args.get("expected") or {}).items()}
        self.device = args.get("device", "cuda")
        self._cuda = (cuda_sha256, cuda_blake3)
        self.tpu_hist = HistAccum()
        # the core's boot runs lthash_of_root over the genesis on the
        # device: the lthash kernel's first launch
        self.core = ReplayCore(
            out_ring=_single(outs, "tower out link", ctx.tile_name),
            out_fseqs=_single(out_fseqs, "tower out link",
                              ctx.tile_name),
            genesis=genesis,
            hashes_per_tick=int(args.get(
                "hashes_per_tick", rp.get("hashes_per_tick", 16))),
            verify_poh=bool(args.get(
                "verify_poh", rp.get("verify_poh", True))),
            slots_per_epoch=int(args.get("slots_per_epoch", 432_000)),
            funk=funk, fanout=fanout, expected=expected,
            wait_restore=bool(args.get("wait_restore", False)),
            snapshot_path=str(args.get("snapshot_path",
                                       sp.get("path", ""))),
            snapshot_every=int(args.get("snapshot_every",
                                        sp.get("every_slots", 0))),
            snapshot_compress=bool(args.get(
                "snapshot_compress", sp.get("compress", True))),
            device=self.device, cnc=getattr(ctx, "cnc", None),
            on_span=lambda kind, ns: self.tpu_hist.add(ns))
        if fanout is not None:
            fanout.m = self.core.metrics   # shared counters, one dict
        self._warmup()
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self._ovr = 0
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]

    def _warmup(self):
        """One one-hash entry through poh_verify on the tile's device, so
        the kernel's build, load and first launch happen at boot (a
        failure or a wrong verdict fails the boot); launches from here
        on are counted."""
        from ..ops.poh import poh_verify_entries
        z = np.zeros((1, 32), np.uint8)
        exp = np.array([list(hashlib.sha256(bytes(32)).digest())],
                       np.uint8)
        ok = poh_verify_entries(z, np.ones(1, np.int32), z,
                                np.zeros(1, bool), exp, max_hashes=1,
                                device=self.device)
        if not bool(ok.all()):
            raise RuntimeError("replay boot: poh_verify rejected a valid "
                               "one-hash entry")
        self._launch0 = (self._cuda[0].launches["poh_verify"],
                         self._cuda[1].launches["lthash"])

    def poll_once(self) -> int:
        if self.core.waiting:
            # cold-start: keep polling for snapin's restore marker;
            # slices gathered below buffer until it lands
            self.core.check_restore()
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, 8, self.mtu)
        self._ovr += ovr
        if n:
            # the poll's slices release together: their slots' PoH
            # checks are one batch
            self.core.on_slices([bytes(buf[i, :sizes[i]])
                                 for i in range(n)])
        return n

    def on_chaos(self, ev: dict):
        """diverge_block: perturb the next replayed slot's state delta;
        its divergence verdict must name that slot. crash_mid_snapshot:
        the next snapshot write exits the process between rows."""
        if ev["action"] == "diverge_block":
            self.core.diverge(int(ev.get("seed", 1)))
        elif ev["action"] == "crash_mid_snapshot":
            self.core._crash_snap = True

    def on_halt(self):
        if self.core.fanout is not None and self.core.fanout.busy:
            self.core.fanout.halt()

    def in_seqs(self):
        s = {self.in_link: self.seq}
        if self.core.fanout is not None:
            s.update(self.core.fanout.done_seq)
        return s

    def metrics_items(self):
        return self.core.metrics | {
            "overruns": self.core.metrics["overruns"] + self._ovr,
            "poh_launches": (self._cuda[0].launches["poh_verify"]
                             - self._launch0[0]),
            "lthash_launches": (self._cuda[1].launches["lthash"]
                                - self._launch0[1])} | {
            f"restore_{k}_us": int(self.core.restore_timing.get(
                f"{k}_s", 0) * 1e6) for k in ("read", "fold", "gate")}


@register("archiver")
class ArchiverAdapter:
    """Frag-stream recorder (ref: src/disco/archiver/ writer tile).
    args: path. Consumes its in link (unreliable by convention — the
    recorder must never backpressure production, matching the
    reference's observer stance)."""

    METRICS = ["frags", "bytes", "overruns"]

    def __init__(self, ctx, args):
        from ..tiles.archiver import ArchiveWriter
        self.ctx = ctx
        self.in_link = next(iter(ctx.in_rings))
        self.tile = ArchiveWriter(ctx.in_rings[self.in_link],
                                  args["path"])

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def in_seqs(self):
        return {self.in_link: self.tile.seq}

    def on_halt(self):
        self.tile.close()

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("playback")
class PlaybackAdapter:
    """Frag-stream replayer (ref: src/disco/archiver/ playback tile).
    args: path."""

    METRICS = ["frags", "bytes", "done", "backpressure"]
    GAUGES = ["done"]

    def __init__(self, ctx, args):
        from ..tiles.archiver import ArchivePlayback
        self.tile = ArchivePlayback(
            args["path"],
            _single(ctx.out_rings, "out link", ctx.tile_name),
            _single(ctx.out_fseqs, "out link", ctx.tile_name))

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("snapld")
class SnapLdAdapter:
    """Snapshot loader tile (ref: src/discof/restore/fd_snapct_tile.c
    download/read orchestration, simplified to local file streaming).

    Chaos seams: corrupt_checkpt_frame flips one seeded byte in the
    next fragment (downstream verify MUST reject the stream);
    crash_mid_snapshot hard-kills this process mid-file (restart
    re-streams from byte 0 — the snapshot protocol is resumable by
    restart, not by offset); stale_snapshot_offer re-offers
    `stale_path`, whose older slot the inserter's min_slot gate must
    refuse. args: path, chunk (both default from the plan's [snapshot]
    section), stale_path."""

    METRICS = ["bytes", "frags", "done", "total_bytes", "corrupted",
               "offers"]
    GAUGES = ["done", "total_bytes"]

    def __init__(self, ctx, args):
        from ..tiles.snapshot import SnapLoader
        sp = ctx.plan.get("snapshot") or {}
        self.stale_path = args.get("stale_path", "")
        self.tile = SnapLoader(
            args.get("path") or sp.get("path"),
            _single(ctx.out_rings, "out link", ctx.tile_name),
            _single(ctx.out_fseqs, "out link", ctx.tile_name),
            chunk=int(args.get("chunk", sp.get("chunk", 1024))))

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def on_chaos(self, ev: dict):
        if ev["action"] == "corrupt_checkpt_frame":
            self.tile._corrupt_seed = int(ev.get("seed", 1))
        elif ev["action"] == "crash_mid_snapshot":
            # die halfway through the file, between publishes
            self.tile._crash_at = max(1, self.tile.size // 2)
        elif ev["action"] == "stale_snapshot_offer" and self.stale_path:
            self.tile.offer(self.stale_path)

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("snapdc")
class SnapDcAdapter:
    """Snapshot decompress tile (ref: src/discof/restore/ snapdc —
    streaming zstd between two frag links). Without the `zstandard`
    package the constructor raises, naming it."""

    METRICS = ["in_bytes", "out_bytes", "frags", "done", "stream_err",
               "backpressure"]
    GAUGES = ["done"]

    def __init__(self, ctx, args):
        from ..tiles.snapshot import SnapDecompress
        self.ctx = ctx
        self.in_link = next(iter(ctx.in_rings))
        self.tile = SnapDecompress(
            ctx.in_rings[self.in_link],
            _single(ctx.out_rings, "out link", ctx.tile_name),
            _single(ctx.out_fseqs, "out link", ctx.tile_name))

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def in_seqs(self):
        return {self.in_link: self.tile.seq}

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("snapin")
class SnapInAdapter:
    """Snapshot inserter tile (ref: src/discof/restore/fd_snapin_tile.c
    — stream -> account DB). format="checkpt" (default): the port's
    checkpoint frames (integrity trailer inside the reader).
    format="archive": the real tar+AppendVec layout, fed DECOMPRESSED
    bytes by an upstream snapdc tile, lattice checksum verified at EOM
    with the BLAKE3 kernel's `lthash` on `device` (default "cuda"; the
    constructor raises without the `zstandard` package).

    Follower mode: when the plan carves a shm funk store ([funk]
    backend="shm"), format="checkpt" restores INTO that shared store
    through WireFunk.from_plan (install-after-verify: every row
    validated before any lands) and then writes the restore marker the
    replay tile gates on — snapshot boot handoff without a control
    channel. min_slot (arg, or [snapshot] min_slot) refuses stale
    snapshots loudly instead of silently rolling the state back.
    `restore_us` (the port's own metric) is the host-clock length of the
    poll that completed the last restore: the message's last frag, the
    verify, the install and the fingerprint."""

    METRICS = ["frags", "bytes", "accounts", "restored", "fingerprint",
               "slot", "lattice_ok", "stream_err", "restore_us"]
    GAUGES = ["accounts", "fingerprint", "slot", "lattice_ok"]

    def __init__(self, ctx, args):
        from ..tiles.snapshot import ArchiveInserter, SnapInserter
        self.ctx = ctx
        self.in_link = next(iter(ctx.in_rings))
        if args.get("format") == "archive":
            self.tile = ArchiveInserter(ctx.in_rings[self.in_link],
                                        device=args.get("device", "cuda"))
        else:
            sp = ctx.plan.get("snapshot") or {}
            funk = None
            fk = ctx.plan.get("funk") or {}
            if fk.get("backend") == "shm" and "off" in fk:
                from ..funk.shmfunk import WireFunk
                funk = WireFunk.from_plan(ctx.wksp, fk)
            self.tile = SnapInserter(
                ctx.in_rings[self.in_link], funk=funk,
                min_slot=int(args.get("min_slot",
                                      sp.get("min_slot", 0))))
        self.restore_us = 0

    def poll_once(self) -> int:
        t0 = time.perf_counter()
        restored = self.tile.metrics["restored"]
        n = self.tile.poll_once()
        if self.tile.metrics["restored"] != restored:
            self.restore_us = int((time.perf_counter() - t0) * 1e6)
        return n

    def in_seqs(self):
        return {self.in_link: self.tile.seq}

    def metrics_items(self):
        return dict(self.tile.metrics) | {"restore_us": self.restore_us}


@register("sign")
class SignAdapter:
    """Identity-key custody tile (ref: src/disco/sign/fd_sign_tile.c).
    args: seed (hex, 32B private key seed), clients = ordered list of
    {role: "leader"|"gossip"|"repair"|"send", req: in link,
    resp: out link} — the role is bound to the ring pair at topology
    build, so policy is attached to the wire. A `keyswitch_off` in the
    tile's plan entry (the live identity hot-swap region) is refused
    (item 13)."""

    METRICS = ["signed", "refused", "overruns", "backpressure"]

    def __init__(self, ctx, args):
        from ..keyguard import SignTile
        from ..keyguard.keyguard import ROLE_NAMES
        if ctx.spec.get("keyswitch_off") is not None:
            refuse("the sign tile's keyswitch region (live identity "
                   "hot-swap)", 13)
        role_ids = {v: k for k, v in ROLE_NAMES.items()}
        self.ctx = ctx
        clients = []
        for c in args["clients"]:
            clients.append({
                "role": role_ids[c["role"]],
                "in_ring": ctx.in_rings[c["req"]],
                "out_ring": ctx.out_rings[c["resp"]],
                "out_fseqs": ctx.out_fseqs[c["resp"]],
            })
        self._links = [c["req"] for c in args["clients"]]
        self.tile = SignTile(bytes.fromhex(args["seed"]), clients)

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def in_seqs(self):
        return {ln: s for ln, s in zip(self._links, self.tile.seqs)}

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("tower")
class TowerAdapter:
    """Consensus tile (ref: src/discof/tower/fd_tower_tile.c): consumes
    block/vote frames, runs ghost + tower checks at housekeeping, emits
    own votes. args: total_stake, in links = the replay fan-in (replay
    blocks and gossip or injected votes on separate links), out link =
    votes. The vote frame carries the FULL tower, lockouts and root
    (tiles/tower.pack_tower_vote), so the send tile can build a real
    TowerSync instruction."""

    METRICS = ["blocks", "votes_in", "votes_out", "lockout_skips",
               "switch_skips", "threshold_skips", "roots", "root_slot",
               "bad_frames", "overruns"]
    GAUGES = ["root_slot"]

    def __init__(self, ctx, args):
        from ..tiles.tower import TowerCore
        self.ctx = ctx
        self.core = TowerCore(int(args["total_stake"]))
        self.seqs = ctx.in_seqs0()
        self.out = _single(ctx.out_rings, "out link", ctx.tile_name)
        self.out_fseqs = _single(ctx.out_fseqs, "out link",
                                 ctx.tile_name)
        self._ovr = 0
        self.mtus = {ln: ctx.plan["links"][ln]["mtu"]
                     for ln in ctx.in_rings}

    def poll_once(self) -> int:
        total = 0
        for ln, ring in self.ctx.in_rings.items():
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], 32, self.mtus[ln])
            self._ovr += ovr
            _trace_consume(self.ctx, ln, sigs, n)
            for i in range(n):
                self.core.handle(bytes(buf[i, :sizes[i]]))
            total += n
        return total

    def housekeeping(self):
        from ..tiles.tower import pack_tower_vote
        decision = self.core.decide()
        if decision is not None:
            slot, block_id = decision
            publish_wave(self.out, self.out_fseqs,
                         [(slot, pack_tower_vote(slot, block_id,
                                                 self.core.tower))],
                         cnc=getattr(self.ctx, "cnc", None))

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return {**self.core.metrics, "overruns": self._ovr}


@register("repair")
class RepairAdapter:
    """Repair tile (ref: src/discof/repair/fd_repair_tile.c:1-15):
    watches the data-shred stream for gaps (forest), sends signed
    repair requests (keyguard REPAIR role) to peers over UDP, serves
    peers' requests from its own shred cache, and forwards repair
    responses onto the out link toward the FEC resolver.

    args: identity_hex, port (0 = ephemeral, published as metric),
    bind_addr, peers = [{pubkey_hex, addr "host:port"}], root_slot,
    req/resp = keyguard links (none: a serve-only tile); shred in link =
    the remaining in link; out link toward the shred tile (optional for
    pure servers); shed (per-tile policing override, disco/shed.py,
    merged over the topology [shed] section: the repair port is
    internet-facing). A sign wait raises SignHalted once the tile leaves
    RUN, so a halt never waits out the keyguard client's timeout."""

    METRICS = ["shreds_seen", "reqs_sent", "sign_fail", "reqs_served",
               "reqs_refused", "resps_in", "cache_slots", "incomplete",
               "overruns", "port", "shed", "shed_unstaked", "peers",
               "overload"]
    GAUGES = ["cache_slots", "incomplete", "port", "peers", "overload"]

    def __init__(self, ctx, args):
        import socket

        from ..keyguard import KeyguardClient
        from ..tiles.repair import RepairCore
        self.ctx = ctx
        resp_ln = args.get("resp")
        ins = [ln for ln in ctx.in_rings if ln != resp_ln]
        self.in_link = _single({ln: ln for ln in ins}, "shred in link",
                               ctx.tile_name)
        self.ring = ctx.in_rings[self.in_link]
        if resp_ln:
            self._kg = KeyguardClient(ctx.out_rings[args["req"]],
                                      ctx.in_rings[resp_ln],
                                      req_fseqs=ctx.out_fseqs[args["req"]],
                                      cnc=getattr(ctx, "cnc", None))
            sign_fn = self._kg.sign
        else:
            self._kg = None
            sign_fn = lambda payload: None        # serve-only tile
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((args.get("bind_addr", "127.0.0.1"),
                   int(args.get("port", 0))))
        sock.setblocking(False)
        self.port = sock.getsockname()[1]
        peers = []
        for p in args.get("peers", []):
            host, port = p["addr"].rsplit(":", 1)
            peers.append((bytes.fromhex(p["pubkey_hex"]),
                          (host, int(port))))
        outs = [ln for ln in ctx.out_rings if ln != args.get("req")]
        # a serve-only tile has no out link
        out_ln = _single({ln: ln for ln in outs}, "shred out link",
                         ctx.tile_name) if outs else None
        self.core = RepairCore(
            bytes.fromhex(args["identity_hex"]), sign_fn, sock,
            peers=peers,
            root_slot=(int(args["root_slot"])
                       if "root_slot" in args else None),
            out_ring=ctx.out_rings.get(out_ln),
            out_fseqs=ctx.out_fseqs.get(out_ln),
            shed=_shed_for(ctx, args))
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self._ovr = 0
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]

    def poll_once(self) -> int:
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, 32, self.mtu)
        self._ovr += ovr
        _trace_consume(self.ctx, self.in_link, sigs, n)
        for i in range(n):
            self.core.on_shred(bytes(buf[i, :sizes[i]]))
        return n + self.core.poll_socket()

    def housekeeping(self):
        if self._kg is not None:
            try:
                self.core.plan_and_send()
            except SignHalted:
                pass    # halting: the plan's other requests are dropped
        _shed_slo_poll(self.ctx, self.core.shed)

    def on_halt(self):
        self.core.sock.close()

    def in_seqs(self):
        seqs = {self.in_link: self.seq}
        if self._kg is not None:
            for ln in self.ctx.in_rings:
                if ln != self.in_link:
                    seqs[ln] = self._kg.resp_seq
        return seqs

    def metrics_items(self):
        gate = (self.core.shed.counters() if self.core.shed is not None
                else {"shed": 0, "shed_unstaked": 0, "peers": 0,
                      "overload": 0})
        return {**self.core.metrics, **gate, "overruns": self._ovr,
                "port": self.port}


@register("send")
class SendAdapter:
    """Vote egress tile (ref: src/discof/send/): consumes vote frames,
    builds the VoteInstruction::TowerSync txn, signs it through the
    keyguard rings and sends it over UDP. args: identity_hex (node
    pubkey; the SEED stays in the sign tile), vote_account_hex, dest
    ("host:port"), req/resp = keyguard links. A sign wait raises
    SignHalted once the tile leaves RUN, as the repair tile's does."""

    METRICS = ["votes", "sent", "sign_fail", "overruns"]

    def __init__(self, ctx, args):
        import socket

        from ..keyguard import KeyguardClient
        from ..tiles.tower import SendCore
        self.ctx = ctx
        vote_in = [ln for ln in ctx.in_rings if ln != args["resp"]]
        self.in_link = _single({ln: ln for ln in vote_in},
                               "vote in link", ctx.tile_name)
        self.ring = ctx.in_rings[self.in_link]
        host, port = args["dest"].rsplit(":", 1)
        kg = KeyguardClient(ctx.out_rings[args["req"]],
                            ctx.in_rings[args["resp"]],
                            req_fseqs=ctx.out_fseqs[args["req"]],
                            cnc=getattr(ctx, "cnc", None))
        self.core = SendCore(
            bytes.fromhex(args["identity_hex"]),
            bytes.fromhex(args["vote_account_hex"]), kg,
            (host, int(port)),
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM))
        self.seq = ctx.in_seq0.get(self.in_link, 0)
        self._ovr = 0
        self.mtu = ctx.plan["links"][self.in_link]["mtu"]

    def poll_once(self) -> int:
        from ..tiles.tower import parse_tower_vote
        n, self.seq, buf, sizes, sigs, ovr = self.ring.gather(
            self.seq, 8, self.mtu)
        self._ovr += ovr
        _trace_consume(self.ctx, self.in_link, sigs, n)
        for i in range(n):
            slot, block_id, lockouts, root = parse_tower_vote(
                bytes(buf[i, :sizes[i]]))
            try:
                self.core.send_vote(slot, block_id, lockouts=lockouts,
                                    root=root)
            except SignHalted:
                break   # halting: what is left of the poll is dropped
        return n

    def on_halt(self):
        self.core.sock.close()

    def in_seqs(self):
        # the keyguard resp link is consumed inside KeyguardClient
        return {self.in_link: self.seq,
                **{ln: self.core.kg.resp_seq
                   for ln in self.ctx.in_rings if ln != self.in_link}}

    def metrics_items(self):
        return {**self.core.metrics, "overruns": self._ovr}


@register("metric")
class MetricAdapter:
    """The observability tile (ref: src/disco/metrics/fd_metric_tile.c
    + fd_prometheus.c): an HTTP endpoint rendered straight from the
    shared-memory metrics/cnc/link regions — reader-side only, so it
    survives any other tile's death — plus the SLO engine evaluated at
    the housekeeping cadence.

      GET /metrics       prometheus text (tile counters, wait/work/tpu
                         histograms, fdtpu_link_* per-link telemetry)
      GET /summary.json  the monitor snapshot + link table + SLO state
      GET /healthz       CNC + heartbeat-staleness roll-up: 200 when
                         every tile is RUN with a fresh heartbeat,
                         503 (with per-tile detail) otherwise

    args: port (0 = ephemeral; bound port published in the "port"
    metric), bind_addr, healthz_stale_s (heartbeat age that flips a
    tile unhealthy, default 5s)."""

    METRICS = ["port", "scrapes", "requests", "slo_breach",
               "slo_breaches", "slo_evals"]
    GAUGES = ["port", "slo_breach"]

    def __init__(self, ctx, args):
        from .httpd import Counter, TileHttpServer
        from .metrics import render_prometheus
        from .slo import SloEngine
        self.ctx = ctx
        self._scrapes = Counter()
        self.stale_ticks = int(
            float(args.get("healthz_stale_s", 5.0)) * 1e9)
        # SLO objectives ride the plan ([slo] section, validated at
        # build); breaches land in THIS tile's flight-recorder ring
        self.engine = SloEngine(ctx.plan, ctx.wksp,
                                trace=getattr(ctx, "trace", None))

        def metrics_route():
            self._scrapes.bump()
            body = render_prometheus(ctx.plan, ctx.wksp).encode()
            return 200, "text/plain; version=0.0.4", body

        def summary_route():
            # the ONE summary-document shape (monitor --json emits the
            # same), plus the SLO state only this tile can evaluate —
            # including the breach-history ring, so a flapping
            # objective reads straight off /summary.json
            from .monitor import full_snapshot
            body = json.dumps({
                **full_snapshot(ctx.plan, ctx.wksp),
                "slo": self.engine.status(),
                "slo_history": list(self.engine.history),
                "catchup": self._catchup(),
            }).encode()
            return 200, "application/json", body

        def healthz_route():
            doc = self._healthz()
            return (200 if doc["ok"] else 503), "application/json", \
                json.dumps(doc).encode()

        self.server = TileHttpServer(
            {"/metrics": metrics_route, "/": metrics_route,
             "/summary.json": summary_route, "/healthz": healthz_route},
            port=int(args.get("port", 0)),
            bind_addr=args.get("bind_addr", "127.0.0.1"))
        self.port = self.server.port

    def _catchup(self) -> dict | None:
        """Replay progress as a summary block: per replay tile its
        catch-up slots. None when the topology has no replay tile."""
        from . import topo as topo_mod
        out = {}
        for tn, spec in self.ctx.plan["tiles"].items():
            if spec["kind"] != "replay":
                continue
            names = spec.get("metrics_names", [])
            vals = topo_mod.read_metrics(self.ctx.wksp, self.ctx.plan,
                                         tn)
            m = {nm: int(vals[i]) for i, nm in enumerate(names)}
            out[tn] = {k: m.get(k, 0) for k in
                       ("slots_replayed", "divergent_slot",
                        "restore_slot", "behind", "buffered")}
        return out or None

    def _healthz(self) -> dict:
        from ..runtime import Cnc, CNC_RUN
        from . import topo as topo_mod
        from .monitor import _STATE
        now = topo_mod.now_ticks()
        tiles = {}
        ok = True
        for tn, spec in self.ctx.plan["tiles"].items():
            cnc = Cnc(self.ctx.wksp, off=spec["cnc_off"])
            state = cnc.state
            age = max(0, now - cnc.last_heartbeat)
            stale = age > self.stale_ticks
            healthy = state == CNC_RUN and not stale
            ok = ok and healthy
            tiles[tn] = {
                "state": _STATE.get(state, f"?{state}"),
                "hb_age_ticks": age, "stale": stale,
                "healthy": healthy,
            }
        return {"ok": ok, "tiles": tiles,
                # informational: a burning SLO is a service problem,
                # not a liveness one — it must not flip readiness
                "slo_breached": [n for n, s in
                                 self.engine.status().items()
                                 if s["breached"]]}

    def housekeeping(self):
        from ..utils import log
        for ev in self.engine.sample():
            log.warning(f"slo {ev['kind']}: {ev['target']} "
                        f"({ev['expr']}) value={ev['value']}")
            if ev["kind"] != "breach":
                continue
            # SLO-breach-triggered device capture (fdprof): ring the
            # doorbell on each [prof] breach_capture tile; its own
            # housekeeping runs the bounded torch.profiler window and
            # acks, so the breach ships with its device attribution
            for tn in (self.ctx.plan.get("prof") or {}).get(
                    "breach_capture") or ():
                from ..prof.device import request_capture
                request_capture(self.ctx.plan, self.ctx.wksp, tn)

    def poll_once(self) -> int:
        return 0

    def on_halt(self):
        self.server.close()

    def metrics_items(self):
        return {"port": self.port,
                "scrapes": self._scrapes.value,
                "requests": self.server.requests.value,
                "slo_breach": self.engine.breached,
                "slo_breaches": self.engine.total_breaches,
                "slo_evals": self.engine.evals}


@register("flight")
class FlightAdapter:
    """fdflight recorder tile: drains the shm observability plane —
    metric slot deltas, link counters + consume-latency quantiles, SLO
    breach/clear transitions, sampled trace events, prof folded-stack
    digests — into the durable on-disk archive the `[flight]` section
    configures (flight/archive.py segments + incident bundles).
    Reader-side only, so writer tiles pay nothing. The drain cadence
    (`[flight].hz`) is rate-limited inside the recorder; the stem just
    calls housekeeping. On halt the recorder takes one final drain and
    seals any pending incident, so a clean shutdown archives its own
    tail.

    args: none — all configuration rides the plan's [flight] section
    (validated at config load and topo.build)."""

    METRICS = ["frames", "drains", "segments", "incidents", "bytes"]
    GAUGES = ["segments"]

    def __init__(self, ctx, args):
        from ..flight.recorder import FlightRecorder
        self.ctx = ctx
        self.recorder = FlightRecorder(ctx.plan, ctx.wksp,
                                       ctx.plan.get("flight"))

    def housekeeping(self):
        self.recorder.maybe_drain()

    def poll_once(self) -> int:
        return 0

    def on_halt(self):
        self.recorder.close()

    def metrics_items(self):
        return dict(self.recorder.metrics)


@register("controller")
class ControllerAdapter:
    """fdtune adaptive-controller tile: the knob mailbox's single
    writer. No links — a pure reader of the shm metrics/SLO plane at
    housekeeping cadence (tune/controller.py Controller), steering the
    runtime knob subset and leaving an EV_TUNE trace record per
    decision (which the flight recorder archives). topo.build refuses
    to boot this kind without an enabled [tune] section, so the
    Controller constructor's mailbox join cannot fail here.

    args: none — all configuration rides the plan's [tune] section
    (validated at config load and topo.build)."""

    METRICS = ["decisions", "reverts", "pressure_pct", "breached",
               "moves_in_window"]
    GAUGES = ["pressure_pct", "breached", "moves_in_window"]

    def __init__(self, ctx, args):
        from ..tune.controller import Controller
        self.ctx = ctx
        self.controller = Controller(ctx.plan, ctx.wksp,
                                     cfg=ctx.plan.get("tune"),
                                     trace=ctx.trace)

    def housekeeping(self):
        self.controller.poll()

    def poll_once(self) -> int:
        return 0

    def metrics_items(self):
        c = self.controller
        return {"decisions": c.decisions, "reverts": c.reverts,
                "pressure_pct": int(c.pressure * 100),
                "breached": int(c.last.get("breached", 0)),
                "moves_in_window": len(c._moves)}


def _shed_for(ctx, args):
    """Resolve one ingest tile's effective shed table from the plan's
    [shed] section + the tile's own `shed` override (disco/shed.py).
    None = no gate object, zero per-packet cost."""
    from .shed import effective_shed
    return effective_shed(ctx.plan.get("shed"), args.get("shed"))


def _shed_slo_poll(ctx, gate):
    """Cross-tile overload coupling, polled at housekeeping cadence:
    an [slo] breach anywhere (the metric tile's slo_breach gauge, via
    the shared PressureProbe roll-up — the same overload definition
    the fdtune controller steers by) trips this tile's door into
    stake-weighted shedding for the hold window. The fdtune
    shed_tighten knob rides the same poll: the controller's posted
    level scales this door's per-peer admit rate."""
    if gate is None:
        return
    probe = getattr(ctx, "_pressure_probe", None)
    if probe is None:
        from .slo import PressureProbe
        probe = ctx._pressure_probe = PressureProbe(ctx.plan, ctx.wksp)
    if probe.overloaded():
        gate.trip_overload()
    knobs = getattr(ctx, "knobs", None)
    if knobs is not None:
        v = knobs.get("shed_tighten")
        if v is not None:
            gate.set_tighten(v)


@register("sock")
class SockAdapter:
    """UDP socket ingest (ref: src/disco/net/sock/fd_sock_tile.c).
    args: port (0 = ephemeral; bound port published in metrics),
    bind_addr, batch, mtu, shed (per-tile policing override —
    disco/shed.py; merged over the topology [shed] section)."""

    METRICS = ["rx", "bytes", "oversz", "backpressure", "shed",
               "shed_unstaked", "shed_overflow", "peers", "overload",
               "port", "rx_staked", "shed_staked"]

    def __init__(self, ctx, args):
        from ..tiles.sock import SockTile
        self.ctx = ctx
        out = _single(ctx.out_rings, "out link", ctx.tile_name)
        fseqs = _single(ctx.out_fseqs, "out link", ctx.tile_name)
        self.tile = SockTile(
            out, fseqs, port=int(args.get("port", 0)),
            bind_addr=args.get("bind_addr", "127.0.0.1"),
            batch=int(args.get("batch", 64)),
            mtu=int(args.get("mtu", 1500)),
            shed=_shed_for(ctx, args))

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def housekeeping(self):
        _shed_slo_poll(self.ctx, self.tile.shed)

    def on_halt(self):
        self.tile.close()

    def metrics_items(self):
        # the port's two more: the datagrams of staked peers the door
        # read, and those of them it shed (the gate's staked_rx and
        # staked_shed; 0 without a gate)
        gate = self.tile.shed
        return {**self.tile.metrics,
                "rx_staked": gate.staked_rx if gate else 0,
                "shed_staked": gate.staked_shed if gate else 0}


@register("quic")
class QuicAdapter:
    """QUIC TPU ingest tile (ref: src/disco/quic/fd_quic_tile.c): the
    production txn ingest transport; each completed unidirectional
    stream publishes one txn frag. args: port (0 = ephemeral, bound
    port in metrics), bind_addr, batch, mtu (clamped to the out link's),
    shed (per-tile policing override, merged over the topology [shed]
    section)."""

    METRICS = ["rx", "txns", "conns", "bad_pkts", "oversz",
               "backpressure", "dropped", "replayed", "shed",
               "shed_unstaked", "peers", "overload", "port"]
    GAUGES = ["peers", "overload", "port"]

    def __init__(self, ctx, args):
        from ..tiles.quic import QuicTile
        self.ctx = ctx
        out_ln = next(iter(ctx.out_rings))
        # never exceed the out link's mtu: an oversize txn must be
        # DROPPED (oversz), not crash Ring.publish on hostile input
        link_mtu = ctx.plan["links"][out_ln]["mtu"]
        self.tile = QuicTile(
            _single(ctx.out_rings, "out link", ctx.tile_name),
            _single(ctx.out_fseqs, "out link", ctx.tile_name),
            port=int(args.get("port", 0)),
            bind_addr=args.get("bind_addr", "127.0.0.1"),
            batch=int(args.get("batch", 64)),
            mtu=min(int(args.get("mtu", 1500)), link_mtu),
            shed=_shed_for(ctx, args))
        self._attack_peer = 0

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def housekeeping(self):
        _shed_slo_poll(self.ctx, self.tile.shed)

    def on_chaos(self, ev: dict):
        """flood_malformed_quic traffic plan: push the hostile
        datagrams straight through the policed rx path, each from a
        fresh fake source address (TEST-NET-3): they must die in the
        QUIC parser as bad_pkts, never crash, never publish a txn."""
        if ev["action"] != "flood_malformed_quic":
            return
        for f in attack_frames(ev["action"], ev["frames"],
                               seed=ev["seed"]):
            self._attack_peer += 1
            self.tile.inject(
                f, (f"203.0.113.{self._attack_peer % 254 + 1}",
                    1024 + self._attack_peer % 60000))

    def on_halt(self):
        self.tile.close()

    def metrics_items(self):
        return dict(self.tile.metrics)


@register("gossip")
class GossipAdapter:
    """Gossip tile (ref: src/discof/gossip/ + src/flamenco/gossip/):
    CRDS over UDP with signed values. args: seed (hex), port,
    bind_addr, entrypoints (["host:port", ...]), publish (list of
    {kind, index, data_hex} values to originate at boot),
    device_verify (check each packet's values as one batch on the
    card, gossip/gossvf.py; default false: the host oracle),
    gossvf_bulk (front that batch with the RLC bulk kernels —
    gossvf mode="bulk"), device ("cuda" | "cpu", gossvf's device),
    shed (per-tile policing override, merged over the topology [shed]
    section)."""

    METRICS = ["gossvf_bad", "rx", "tx", "values", "contacts",
               "bad_msg", "shed", "shed_unstaked", "peers",
               "overload", "port"]

    def __init__(self, ctx, args):
        from ..tiles.gossip import GossipTile
        self.ctx = ctx
        device = args.get("device", "cuda")
        device_verify = bool(args.get("device_verify", False))
        if device_verify:
            _device.resolve(device)        # no usable card: raise
        self.tile = GossipTile(
            bytes.fromhex(args["seed"]),
            port=int(args.get("port", 0)),
            bind_addr=args.get("bind_addr", "127.0.0.1"),
            entrypoints=args.get("entrypoints", ()),
            device_verify=device_verify,
            gossvf_bulk=bool(args.get("gossvf_bulk", False)),
            shed=_shed_for(ctx, args), device=device)
        self._attack_peer = 0
        for v in args.get("publish", []):
            self.tile.publish(int(v["kind"]), int(v.get("index", 0)),
                              bytes.fromhex(v["data_hex"]))

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def on_chaos(self, ev: dict):
        """flood_crds_spam traffic plan: validly signed CRDS push spam
        from many throwaway unstaked origins (the Sybil flood),
        injected through the policed rx path from fake TEST-NET-2
        socket addresses — the bounded peer table + stake gate must
        absorb it without growing."""
        if ev["action"] != "flood_crds_spam":
            return
        for f in attack_frames(ev["action"], ev["frames"],
                               seed=ev["seed"]):
            self._attack_peer += 1
            self.tile.inject(
                f, (f"198.51.100.{self._attack_peer % 254 + 1}",
                    1024 + self._attack_peer % 60000))

    def housekeeping(self):
        self.tile.housekeeping()
        _shed_slo_poll(self.ctx, self.tile.shed)

    def on_halt(self):
        self.tile.close()

    def metrics_items(self):
        return dict(self.tile.metrics)
