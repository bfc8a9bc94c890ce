"""Tile adapters + registry: kind string -> runnable tile object (copy of
the four adapters of the JAX package's disco/tiles.py that the main path
runs: synth, verify, dedup, sink).

An adapter is constructed inside the tile process from (TileCtx, args)
and supplies the stem callbacks (poll_once / metrics_items / in_seqs /
on_halt); ref: src/disco/topo/fd_topo.h:664-684.

Where the copy differs from the reference:
  * the registry holds these four kinds only; `Topology.tile` refuses
    every other kind of the reference's registry (disco/unported.py),
    and `adapter_class` raises ValueError for a name without an
    adapter;
  * SynthAdapter has no traffic plans (`on_chaos`, tiles.py:221-262;
    `Topology.tile` refuses every `chaos` arg);
  * VerifyAdapter wraps the port's VerifyTile, which runs on the card
    unless its `device` arg (default "cuda") says "cpu"; that arg is the
    port's counterpart of the reference's FDTPU_JAX_PLATFORM override
    (tiles.py:120-133). Its device-degradation args (device_retries,
    device_timeout_s, device_fail_limit) are refused (item 2), and so
    are the JAX compile and memory series and the profiler capture
    (tiles.py:357-426, item 6) and the fdtune knob hook (item 11);
  * no trace hooks (item 2).
"""
from __future__ import annotations

import time

import numpy as np

from ..protocol.txn import MTU
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


@register("synth")
class SynthAdapter:
    """Load generator (the reference's benchg tile,
    ref: src/app/shared_dev/commands/bench/fd_benchg_tile.c).
    args: count (total txns), unique, seed, burst, rate_tps (0 =
    unpaced; token-bucket pacing for an offered-load sweep). rate_tps
    may also be a RAMP SCHEDULE, a list of (duration_s, tps) stanzas;
    past the schedule's end the last stanza's rate holds."""

    METRICS = ["tx", "backpressure"]

    def __init__(self, ctx, args):
        from ..tiles.synth import make_signed_txns
        self.ctx = ctx
        self.count = int(args.get("count", 1024))
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
        stop, pub = self.out.publish_batch(
            self._buf[idx], self._sizes[idx],
            np.arange(self.sent, self.sent + b, dtype=np.uint64),
            np.ones(b, np.uint8), fseqs=self.fseqs)
        if stop < b:
            self.bp += 1
        self.sent += pub
        return pub

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
        return {"tx": self.sent, "backpressure": self.bp}


@register("verify")
class VerifyAdapter:
    """Sigverify tile on the card (ref: src/disco/verify/fd_verify_tile.h)
    over the port's tiles/verify.py::VerifyTile.
    args: batch, max_len, tcache (name), rr_cnt, rr_idx, devices,
    coalesce_us, mode ("strict" | "bulk_prefilter"), prefilter_shed,
    device ("cuda" | "cpu")."""

    METRICS = ["rx", "parse_fail", "dedup_drop", "verify_fail", "tx",
               "overruns", "batches", "backpressure", "device_errors",
               "cpu_fallback", "rlc_batches", "rlc_pass", "rlc_lanes",
               "rlc_shed", "rlc_ns",
               # batches in flight, and the boot warmup's wall time (the
               # kernels' build and first launch)
               "tpu_inflight", "tpu_compile_ns"]

    def __init__(self, ctx, args):
        from ..tiles.verify import VerifyTile
        for key in ("device_retries", "device_timeout_s",
                    "device_fail_limit"):
            if key in args:
                refuse(f"verify arg {key!r} (device degradation)", 2)
        self.ctx = ctx
        in_ring = _single(ctx.in_rings, "in link", ctx.tile_name)
        out_ring = _single(ctx.out_rings, "out link", ctx.tile_name)
        tc_name = args.get("tcache")
        tc = ctx.tcaches[tc_name] if tc_name \
            else _single(ctx.tcaches, "tcache", ctx.tile_name)
        self.tile = VerifyTile(
            in_ring, out_ring, tc,
            batch=int(args.get("batch", 256)),
            max_len=int(args.get("max_len", MTU)),
            out_fseqs=_single(ctx.out_fseqs, "out link", ctx.tile_name),
            dedup_seed=bytes.fromhex(ctx.plan["seed"]),
            rr_cnt=int(args.get("rr_cnt", 1)),
            rr_idx=int(args.get("rr_idx", 0)),
            devices=int(args.get("devices", 1)),
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

    def poll_once(self) -> int:
        return self.tile.poll_once()

    def on_halt(self):
        self.tile.flush()      # publish verdicts already in flight

    def in_seqs(self):
        return {self.in_link: self.tile.seq}

    def metrics_items(self):
        m = dict(self.tile.metrics)
        m["tpu_inflight"] = len(self.tile._pending)
        m["tpu_compile_ns"] = self.tile.compile_ns
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

    def poll_once(self) -> int:
        total = 0
        for ln, ring in self.ctx.in_rings.items():
            n, self.seqs[ln], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ln], self.batch, self.mtu)
            self.m["overruns"] += ovr
            if not n:
                continue
            total += n
            self.m["rx"] += n
            # the whole gather dedups as ONE native insert-or-dup call
            # and forwards as credit-gated native batch publishes
            dup = self.tcache.insert_batch(sigs[:n])
            self.m["dup"] += int(dup.sum())
            mask = (dup == 0).astype(np.uint8)
            start = 0
            while True:
                stop, pub = self.out.publish_batch(
                    buf[:n], sizes[:n], sigs[:n], mask,
                    fseqs=self.out_fseqs, start=start)
                self.m["tx"] += pub
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
            total += n
        return total

    def in_seqs(self):
        return dict(self.seqs)

    def metrics_items(self):
        return dict(self.m)
