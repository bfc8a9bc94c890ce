"""Stem: the tile run loop (copy of the JAX package's disco/stem.py:30-377
with its chaos harness, trace and fdprof hooks, and the pinned or
depth-derived housekeeping cadence, `lazy_ns` and `lazy_auto`).

Re-expression of the reference's run loop (ref: src/disco/stem/
fd_stem.c:1-168, :240 run1, :385 the main for(;;)). A tile object
supplies the callbacks as methods:

  poll_once() -> int      frags consumed this iteration (0 = idle)
  housekeeping()          optional, called at the lazy interval (the poh
                          tile's tick clock)
  metrics_items() -> dict optional, name -> int, flushed to shm metrics
  in_seqs() -> dict       optional, consumer progress per in link
  on_halt()               optional, called once on a clean exit
  on_chaos(ev)            optional, gets the chaos events the stem does
                          not run itself (traffic floods, diverge_block)

The stem owns what every tile shares: cnc lifecycle (BOOT -> RUN ->
HALT/FAIL), heartbeating, the lazy housekeeping interval with jitter,
consumer-side fseq publication (so upstream producers can credit-gate),
the wait/work/tpu histograms, and flushing tile metrics and the per-link
telemetry counters into shared memory. With a chaos plan in the tile's
args (utils/chaos.py) it fires the plan's events; with a trace ring
(`ctx.trace`) it records BOOT, a WAIT span per idle streak, WORK spans
(one a `sample` productive polls, summed), HOUSEKEEP, FAIL and HALT; with
a profile region (`ctx.prof`) it runs the fdprof sampler thread from RUN
to any exit and tells it, each poll, whether the loop waits, works or
housekeeps and which in link it served. An untraced, unprofiled tile's
only cost is the cached `None` checks.

The housekeeping interval is `hk_interval_s` unless the tile's args pin
it (`lazy_ns`) or ask for the depth-derived cadence (`lazy_auto`:
utils/tempo.lazy_default of the smallest out-link depth, clamped to
[100 µs, 50 ms]).
"""
from __future__ import annotations

import os
import random
import threading
import time

from ..runtime import CNC_RUN, CNC_HALT, CNC_FAIL
from ..trace import chaos_event
from ..trace import events as trace_ev
from ..utils import log
from ..utils.chaos import ChaosPlan
from ..utils.tempo import lazy_default
from .metrics import HIST_U64, HistAccum


class Stem:
    def __init__(self, ctx, tile, hk_interval_s: float = 0.01,
                 idle_sleep_s: float = 20e-6):
        """ctx: TileCtx (cnc/metrics/fseqs); tile: the callback object."""
        self.ctx, self.tile = ctx, tile
        self.hk_interval_s = hk_interval_s
        # tempo-derived cadence (ref: fd_tempo_lazy_default): a pinned
        # lazy_ns, or lazy_auto (credits must return some 10x faster
        # than the smallest out-link window drains)
        args = ctx.spec.get("args", {})
        if args.get("lazy_ns"):
            self.hk_interval_s = int(args["lazy_ns"]) * 1e-9
        elif args.get("lazy_auto"):
            depths = [ctx.plan["links"][ln]["depth"]
                      for ln in getattr(ctx, "out_rings", {})]
            if depths:
                # floor: the Python loop's useful granularity (100 µs);
                # ceiling: heartbeats stay frequent
                self.hk_interval_s = min(0.05, max(
                    1e-4, lazy_default(min(depths)) * 1e-9))
        self.idle_sleep_s = idle_sleep_s
        # slot-name ABI: the plan's names, in slot order
        self._metrics_names = ctx.spec["metrics_names"]
        # wait/work poll latency histograms, and the tile's own tpu
        # histogram, seeded from shm so a supervised restart resumes the
        # cumulative series
        self._hists = {"wait": HistAccum(), "work": HistAccum()}
        hv = ctx.hist_view()
        self._hists["wait"].seed_from(hv[0:HIST_U64])
        self._hists["work"].seed_from(hv[HIST_U64:2 * HIST_U64])
        tpu = getattr(tile, "tpu_hist", None)
        if tpu is not None:
            tpu.seed_from(hv[2 * HIST_U64:3 * HIST_U64])
        # per-link consume latency: each productive poll's duration is
        # attributed to every in link whose consume counter advanced
        self._link_hists = {ln: HistAccum() for ln in ctx.link_cons_views}
        for ln, h in self._link_hists.items():
            h.seed_from(ctx.link_cons_views[ln][3:3 + HIST_U64])
        self._link_seen = {ln: ctx.in_rings[ln].m_consumed
                           for ln in self._link_hists}
        # chaos harness: a seeded fault plan from the tile's args
        chaos = args.get("chaos")
        self._chaos = ChaosPlan(chaos) if chaos else None
        self._hb_frozen = False
        self._wedged = False
        self._stalled_links: set | None = None   # None = no stall
        # flight recorder: None on an untraced tile, the whole disabled
        # path
        self._trace = getattr(ctx, "trace", None)
        # fdprof: None on an unprofiled tile. The sampler thread starts
        # in run() (it samples the stem's thread); _prof_state is the
        # channel the loop stores wait/work/housekeep and the active in
        # link into, one attribute store a poll. A sample sees the state
        # set after the previous poll.
        self._prof_region = getattr(ctx, "prof", None)
        self._prof_state = None
        self._sampler = None
        self._wait_t0: int | None = None      # idle-streak start (ns)
        # with sample > 1 one EV_WORK record sums the last `sample`
        # productive polls
        self._work_ns = 0
        self._work_frags = 0
        self._work_polls = 0

    def _apply_chaos(self, iters: int, rx: int):
        for ev in self._chaos.poll(iters, rx):
            act = ev["action"]
            log.warning(f"chaos: firing {act} (iter={iters} rx={rx})")
            # recorded BEFORE acting, so even a crash leaves its
            # footprint for the black-box dump
            chaos_event(self._trace, act, at=iters)
            if act == "crash":
                os._exit(ev["code"])
            elif act == "freeze_hb":
                self._hb_frozen = True
            elif act == "wedge":
                self._hb_frozen = True
                self._wedged = True
            elif act == "stall_fseq":
                if self._stalled_links is None:
                    self._stalled_links = set()
                self._stalled_links.add(ev["link"])   # None = all links
            else:
                # traffic and replay drills: the adapter owns them
                hook = getattr(self.tile, "on_chaos", None)
                if hook is not None:
                    hook(ev)

    def _stop_sampler(self):
        """Stop the fdprof sampler on any loop exit; the shm region keeps
        the aggregate."""
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None
            self._prof_state = None

    def _trace_flush(self, tr):
        """Close out pending trace state on any loop exit: the summed but
        unrecorded work window and an open wait streak are the last thing
        the tile was doing."""
        if self._work_polls:
            tr.event(trace_ev.EV_WORK, arg=self._work_ns,
                     count=self._work_frags)
            self._work_ns = self._work_frags = self._work_polls = 0
        if self._wait_t0 is not None:
            tr.event(trace_ev.EV_WAIT,
                     arg=time.perf_counter_ns() - self._wait_t0)
            self._wait_t0 = None

    def _flush_metrics(self):
        items = getattr(self.tile, "metrics_items", None)
        if items is not None:
            d = items()
            view = self.ctx.metrics_view()
            for i, k in enumerate(self._metrics_names):
                view[i] = d.get(k, 0)
        hv = self.ctx.hist_view()
        self._hists["wait"].flush_into(hv[0:HIST_U64])
        self._hists["work"].flush_into(hv[HIST_U64:2 * HIST_U64])
        tpu = getattr(self.tile, "tpu_hist", None)
        if tpu is not None:
            tpu.flush_into(hv[2 * HIST_U64:3 * HIST_U64])
        # the Ring joins' counters are the per-link truth for this tile;
        # flushed wholesale, so the hot path writes no shm
        for ln, view in self.ctx.link_cons_views.items():
            r = self.ctx.in_rings[ln]
            view[0] = r.m_consumed
            view[1] = r.m_bytes
            view[2] = r.m_overruns
            self._link_hists[ln].flush_into(view[3:3 + HIST_U64])
        for ln, view in self.ctx.link_prod_views.items():
            r = self.ctx.out_rings[ln]
            view[0] = r.m_pub
            view[1] = r.m_pub_bytes
            view[2] = r.m_backpressure

    def _update_in_fseqs(self):
        """Publish consumer progress so upstream producers see credits."""
        seqs = getattr(self.tile, "in_seqs", None)
        if seqs is None:
            return
        cur = seqs()
        for ln, fs in self.ctx.in_fseqs.items():
            if self._stalled_links is not None and \
                    (None in self._stalled_links
                     or ln in self._stalled_links):
                continue              # chaos: progress frozen
            if ln in cur:
                fs.update(cur[ln])

    def run(self, max_iters: int | None = None):
        tr = self._trace
        cnc = self.ctx.cnc
        cnc.heartbeat()
        cnc.state = CNC_RUN
        if self._prof_region is not None and self._sampler is None:
            # the host sampling profiler over this thread: the daemon
            # sampler walks its stack at prof_hz into the shm region
            from ..prof import ProfState, Sampler
            spec = self.ctx.spec
            self._prof_state = ProfState()
            self._sampler = Sampler(
                self._prof_region, float(spec.get("prof_hz", 97.0)),
                threading.get_ident(), self._prof_state,
                stack_depth=int(spec.get("prof_stack_depth", 16)),
            ).start()
        ps = self._prof_state
        if tr is not None:
            tr.event(trace_ev.EV_BOOT)
        # jittered lazy interval (fd_stem.c: avoid phase-locking tiles)
        next_hk = 0.0
        iters = 0
        rx_total = 0
        try:
            while True:
                now = time.perf_counter()
                if now >= next_hk:
                    if not self._hb_frozen:
                        cnc.heartbeat()
                    st = cnc.state
                    if st == CNC_HALT:
                        break
                    if st == CNC_FAIL:
                        # externally failed (wedge watchdog): exit NOW,
                        # leaving the FAIL state visible
                        if tr is not None:
                            self._trace_flush(tr)
                            tr.event(trace_ev.EV_FAIL)
                        self._flush_metrics()
                        self._stop_sampler()
                        return
                    hk_t0 = time.perf_counter_ns() if tr is not None \
                        else 0
                    if ps is not None:
                        ps.state = 2          # fdprof: housekeep
                    self._update_in_fseqs()
                    hk = getattr(self.tile, "housekeeping", None)
                    if hk is not None:
                        hk()
                    self._flush_metrics()
                    if tr is not None:
                        tr.event(trace_ev.EV_HOUSEKEEP,
                                 arg=time.perf_counter_ns() - hk_t0)
                    next_hk = now + self.hk_interval_s * (
                        0.7 + 0.6 * random.random())
                if self._wedged:
                    # chaos: a hung tile, no polling and no heartbeats,
                    # still halt-able and killable by the supervisor
                    time.sleep(0.005)
                    iters += 1
                    continue
                t0 = time.perf_counter_ns()
                n = self.tile.poll_once()
                t1 = time.perf_counter_ns()
                # an idle poll is time spent waiting on upstream, a
                # productive one is work
                self._hists["work" if n else "wait"].add(t1 - t0)
                if ps is not None:
                    ps.state = 1 if n else 0  # fdprof: work / wait
                if n:
                    for ln, h in self._link_hists.items():
                        c = self.ctx.in_rings[ln].m_consumed
                        if c != self._link_seen[ln]:
                            self._link_seen[ln] = c
                            h.add(t1 - t0)
                            if ps is not None:
                                ps.link = ln  # fdprof: active in link
                if tr is not None:
                    # one WAIT span per idle streak (from its first empty
                    # poll to the start of the next productive one), one
                    # WORK span per `sample` productive polls
                    if n:
                        if self._wait_t0 is not None:
                            # stamped at t0, where the streak ended;
                            # perf_counter_ns and monotonic_ns are both
                            # CLOCK_MONOTONIC here
                            tr.ring.append(t0, trace_ev.EV_WAIT,
                                           arg=t0 - self._wait_t0)
                            self._wait_t0 = None
                        self._work_ns += t1 - t0
                        self._work_frags += n
                        self._work_polls += 1
                        if self._work_polls >= tr.sample:
                            tr.event(trace_ev.EV_WORK, arg=self._work_ns,
                                     count=self._work_frags)
                            self._work_ns = 0
                            self._work_frags = 0
                            self._work_polls = 0
                    elif self._wait_t0 is None:
                        self._wait_t0 = t0
                if not n:
                    time.sleep(self.idle_sleep_s)
                iters += 1
                rx_total += n
                if self._chaos is not None:
                    self._apply_chaos(iters, rx_total)
                if max_iters is not None and iters >= max_iters:
                    break
        except Exception as e:
            cnc.state = CNC_FAIL
            if tr is not None:
                self._trace_flush(tr)
                tr.event(trace_ev.EV_FAIL)
            self._flush_metrics()
            self._stop_sampler()
            log.err(f"tile failed: {e!r}")
            raise
        # drain-side bookkeeping before exit; the reference flushes
        # before on_halt (stem.py:368-372), the copy after it, so what
        # the halt path publishes is counted too
        on_halt = getattr(self.tile, "on_halt", None)
        if on_halt is not None:
            on_halt()
        self._update_in_fseqs()
        self._flush_metrics()
        if tr is not None:
            self._trace_flush(tr)
            tr.event(trace_ev.EV_HALT)
        self._stop_sampler()
        cnc.state = CNC_HALT
