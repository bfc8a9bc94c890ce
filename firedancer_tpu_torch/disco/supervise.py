"""Tile supervision: restart policies, wedge watchdog, circuit breaker,
and the flight recorder's black-box dumps (copy of the JAX package's
disco/supervise.py:55-396).

The reference's posture is a supervised tile topology: every tile
exposes a cnc state machine + heartbeat (ref: src/tango/cnc/
fd_cnc.h:6-40) that a supervisor watches (ref: src/app/shared/commands/
run/run.c:229-260,925 — the pid-namespace "one tile dies => everything
dies" supervisor). This module grows that fail-fast baseline into a
policy layer:

  fail_fast   (default) any abnormal tile death fails the topology —
              exactly the seed behavior.
  restart     the supervisor respawns the tile with exponential
              backoff; more than `max_restarts` restarts inside
              `window_s` opens the circuit breaker, which cleanly
              halts the topology (bounded restarts — never a crash
              loop, never a wedge).

Wedge watchdog: a tile can be live-but-stuck (heartbeats stale, or a
consumer whose fseq stopped advancing while its producer is blocked on
it). The watchdog transitions such a tile to CNC_FAIL, kills it, and
applies its restart policy.

Ring rejoin: a restarted consumer must not replay the whole ring or
wedge upstream credit flow. While a tile is down its consumer fseqs are
marked STALE (runtime/tango.py FSEQ_STALE — the native fctl skips the
sentinel), and the respawned process joins each in ring at the
producer's CURRENT seq (`rejoin_at_tail` in the plan -> TileCtx seeds
in_seq0 + fseqs from ring.seq). Frags published while the tile was down
are skipped for that consumer — the same documented loss contract as an
unreliable consumer's overrun.

Supervisor counters live in the TOP slots of each tile's metrics region
(the tile itself writes only its own named slots from 0 up, capped at
SUP_SLOT_MIN by Topology.build), so restarts/watchdog trips are
readable by the monitor and prometheus renderer exactly like tile
metrics — and survive the tile's restarts.
"""
from __future__ import annotations

import time
from collections import deque

from ..runtime import Cnc, CNC_RUN, CNC_HALT, CNC_FAIL, Fseq, Ring
from ..trace import dump_blackbox, writer_for
from ..trace.events import EV_DOWN, EV_RESTART, EV_WATCHDOG

# supervisor-owned metric slots (indices into the METRICS_SLOTS region)
SUP_SLOTS = {
    "sup_restarts": 63,        # counter: times this tile was respawned
    "sup_watchdog_trips": 62,  # counter: wedge watchdog kills
    "sup_down": 61,            # gauge: 1 while dead/awaiting respawn
}
SUP_GAUGES = {"sup_down"}
SUP_SLOT_MIN = min(SUP_SLOTS.values())


def sup_counters(vals) -> dict:
    """name -> value from a tile's raw metric-slot array — the ONE
    place that knows the supervisor slot indices; every reader
    (monitor, prometheus, TopologyRunner.metrics) goes through here."""
    return {nm: int(vals[slot]) for nm, slot in SUP_SLOTS.items()}

POLICIES = ("fail_fast", "restart")

_DEFAULTS = {
    "policy": "fail_fast",
    "backoff_s": 0.05,         # first restart delay
    "backoff_max_s": 1.0,      # exponential cap (x2 per consecutive)
    "max_restarts": 3,         # inside window_s -> circuit breaker
    "window_s": 30.0,
    "wedge_timeout_s": None,   # heartbeat/progress staleness deadline
}


def normalize_policy(spec) -> dict:
    """Validate + default-fill a per-tile supervision spec (the `supervise`
    tile arg / TOML table). Returns a plain JSON-able dict for the plan."""
    out = dict(_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"supervise spec must be a table, got {spec!r}")
    unknown = set(spec) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown supervise keys {sorted(unknown)}")
    out.update(spec)
    if out["policy"] not in POLICIES:
        raise ValueError(f"supervise.policy must be one of {POLICIES}, "
                         f"got {out['policy']!r}")
    for k in ("backoff_s", "backoff_max_s", "window_s"):
        out[k] = float(out[k])
        if out[k] <= 0:
            raise ValueError(f"supervise.{k} must be > 0")
    out["max_restarts"] = int(out["max_restarts"])
    if out["max_restarts"] < 1:
        raise ValueError("supervise.max_restarts must be >= 1")
    if out["wedge_timeout_s"] is not None:
        out["wedge_timeout_s"] = float(out["wedge_timeout_s"])
        if out["wedge_timeout_s"] <= 0:
            raise ValueError("supervise.wedge_timeout_s must be > 0")
    return out


class CircuitOpen(RuntimeError):
    """A restart-policy tile exceeded its restart budget; the topology
    was cleanly halted."""


class _TileState:
    __slots__ = ("restart_times", "down_since", "next_restart_t",
                 "backoff_s", "exitcode", "fseq_marks")

    def __init__(self):
        self.restart_times: deque = deque()
        self.down_since: float | None = None
        self.next_restart_t: float = 0.0
        self.backoff_s: float | None = None
        self.exitcode = None
        self.fseq_marks: dict = {}    # link -> (value, t_last_changed)


class Supervisor:
    """Policy engine over a running topology.

    Decoupled from TopologyRunner through three callables so the logic
    is unit-testable with fake processes:

      procs()            -> {tile: proc-like (is_alive, exitcode,
                             terminate, kill, join)}
      spawn(tile, rejoin)-> start a replacement process
      halt_all()         -> cleanly stop the whole topology
    """

    def __init__(self, plan: dict, wksp, procs, spawn, halt_all,
                 clock=time.monotonic):
        self.plan = plan
        self.wksp = wksp
        self._procs = procs
        self._spawn = spawn
        self._halt_all = halt_all
        self._clock = clock
        self.policies = {tn: spec.get("supervise") or dict(_DEFAULTS)
                         for tn, spec in plan["tiles"].items()}
        self.state = {tn: _TileState() for tn in plan["tiles"]}
        self._rings = {ln: Ring(wksp, li["ring_off"], li["depth"],
                                li["arena_off"], li["mtu"])
                       for ln, li in plan["links"].items()}
        # link -> producing tile (for consumer-progress watchdog)
        self._producer = {}
        for tn, spec in plan["tiles"].items():
            for ln in spec["outs"]:
                self._producer[ln] = tn
        # hot-loop handles are fixed at build time — cache them so a
        # 50ms supervision cadence doesn't re-parse plan offsets and
        # re-allocate Cnc/Fseq/array views every pass
        self._cncs = {tn: Cnc(wksp, off=spec["cnc_off"])
                      for tn, spec in plan["tiles"].items()}
        self._tile_fseqs = {tn: self._build_in_fseqs(tn)
                            for tn in plan["tiles"]}
        self._slot_views = {tn: self._build_slots(tn)
                            for tn in plan["tiles"]}
        # flight recorder: a writer over each traced tile's ring (None
        # when untraced). The supervisor appends only after the owning
        # tile died or was killed, so the ring keeps one writer at a
        # time; blackbox holds the last dump path per tile
        self._trace = {tn: writer_for(plan, wksp, tn)
                       for tn in plan["tiles"]}
        self.blackbox: dict[str, str] = {}

    # -- shm counter helpers ------------------------------------------------

    def _build_slots(self, tn: str):
        import numpy as np
        from .topo import METRICS_SLOTS
        off = self.plan["tiles"][tn]["metrics_off"]
        return self.wksp.view(off, METRICS_SLOTS * 8).view(np.uint64)

    def _slots(self, tn: str):
        return self._slot_views[tn]

    def _bump(self, tn: str, name: str, delta: int = 1):
        self._slots(tn)[SUP_SLOTS[name]] += delta

    def _set(self, tn: str, name: str, value: int):
        self._slots(tn)[SUP_SLOTS[name]] = value

    def counters(self, tn: str) -> dict:
        v = self._slots(tn)
        return {name: int(v[slot]) for name, slot in SUP_SLOTS.items()}

    def _cnc(self, tn: str) -> Cnc:
        return self._cncs[tn]

    def _build_in_fseqs(self, tn: str):
        """(link, Fseq) pairs for the tile's reliable in links."""
        out = []
        for i in self.plan["tiles"][tn]["ins"]:
            key = f"{i['link']}:{tn}"
            off = self.plan["fseqs"].get(key)
            if i.get("reliable") and off is not None:
                out.append((i["link"], Fseq(self.wksp, off=off)))
        return out

    def _in_fseqs(self, tn: str):
        return self._tile_fseqs[tn]

    # -- flight-recorder integration ----------------------------------------

    def _trace_mark(self, tn: str, etype: int):
        tr = self._trace.get(tn)
        if tr is not None:
            tr.event(etype)

    def _dump_blackbox(self, tn: str, reason: str):
        """Snapshot the dying tile's last trace events out of shm before
        a restart reuses its ring."""
        if self._trace.get(tn) is None:
            return
        try:
            path = dump_blackbox(self.plan, self.wksp, tn, reason)
        except OSError:
            return                        # a dump never blocks recovery
        if path:
            self.blackbox[tn] = path

    # -- policy machinery ---------------------------------------------------

    def _mark_down(self, tn: str, now: float, exitcode):
        pol = self.policies[tn]
        st = self.state[tn]
        st.down_since = now
        st.exitcode = exitcode
        if st.restart_times and \
                now - st.restart_times[-1] > pol["window_s"]:
            st.backoff_s = None      # stable for a full window: reset
        st.backoff_s = pol["backoff_s"] if st.backoff_s is None \
            else min(st.backoff_s * 2, pol["backoff_max_s"])
        st.next_restart_t = now + st.backoff_s
        self._set(tn, "sup_down", 1)
        self._cnc(tn).state = CNC_FAIL    # visible to monitor/metrics
        # exclude the dead consumer from upstream credit flow NOW —
        # producers must keep flowing while the tile is down
        for _, fs in self._in_fseqs(tn):
            fs.mark_stale()

    def _open_circuit(self, tn: str):
        self._cnc(tn).state = CNC_FAIL
        self._halt_all()
        raise CircuitOpen(
            f"tile {tn}: circuit breaker open "
            f"({self.policies[tn]['max_restarts']} restarts in "
            f"{self.policies[tn]['window_s']}s) — topology halted")

    def _restart(self, tn: str, now: float):
        pol = self.policies[tn]
        st = self.state[tn]
        # every restart ATTEMPT (spawn or deferred kill-retry) consumes
        # breaker budget, so an unkillable process cannot hold the
        # topology half-down forever — the breaker eventually opens
        st.restart_times.append(now)
        while st.restart_times and \
                st.restart_times[0] < now - pol["window_s"]:
            st.restart_times.popleft()
        if len(st.restart_times) > pol["max_restarts"]:
            self._open_circuit(tn)
        old = self._procs().get(tn)
        if old is not None and old.is_alive():
            # the previous process is not reaped yet (e.g. stuck in an
            # uninterruptible device ioctl): spawning now would put TWO
            # producers on the same rings/fseqs — retry the kill and
            # defer the respawn with escalating backoff instead
            self._kill(tn)
            if old.is_alive():
                st.backoff_s = min(st.backoff_s * 2,
                                   pol["backoff_max_s"])
                st.next_restart_t = now + st.backoff_s
                return
        self._bump(tn, "sup_restarts")
        self._trace_mark(tn, EV_RESTART)   # before the respawn owns it
        self._spawn(tn, rejoin=True)
        st.down_since = None
        st.fseq_marks.clear()
        self._set(tn, "sup_down", 0)

    def _kill(self, tn: str):
        p = self._procs().get(tn)
        if p is None:
            return
        p.terminate()
        p.join(2.0)
        if p.is_alive():
            p.kill()
            p.join(2.0)

    def _watchdog_due(self, tn: str, now: float) -> str | None:
        """None, or the reason this live tile counts as wedged."""
        pol = self.policies[tn]
        deadline = pol["wedge_timeout_s"]
        if deadline is None:
            return None
        cnc = self._cnc(tn)
        if cnc.state != CNC_RUN:
            return None                 # boot compile / halting: exempt
        # heartbeats are stamped with the same monotonic-ns source
        # (utils/tempo.monotonic_ns == native fdtpu_ticks)
        from ..utils.tempo import monotonic_ns
        age_s = max(0, monotonic_ns() - cnc.last_heartbeat) / 1e9
        if age_s > deadline:
            return f"heartbeat stale {age_s:.2f}s"
        # consumer-progress watch: an fseq that stopped advancing while
        # its producer sits blocked on it (ring full against this
        # consumer) is a wedged consumer even with fresh heartbeats.
        # The staleness clock starts when the consumer first becomes
        # BLOCKED-AGAINST (same fseq value AND backlog >= depth), not
        # when the value was first observed — a consumer idle behind a
        # slow-starting producer is waiting, not wedged, and must not
        # be killed the instant the ring fills (mark = (val, t_blocked);
        # t_blocked is None while the ring is not full against it)
        st = self.state[tn]
        for ln, fs in self._in_fseqs(tn):
            val = fs.query()
            ring = self._rings[ln]
            backlog = ring.seq - val
            blocked = backlog >= ring.depth   # stale sentinel: negative
            prev = st.fseq_marks.get(ln)
            if prev is None or prev[0] != val or not blocked:
                st.fseq_marks[ln] = (val, now if blocked else None)
                continue
            if prev[1] is None:
                st.fseq_marks[ln] = (val, now)
                continue
            if now - prev[1] > deadline:
                return (f"consumer stalled on {ln} "
                        f"(backlog {backlog} >= depth {ring.depth})")
        return None

    # -- the supervision pass ----------------------------------------------

    def poll(self):
        """One supervision pass. Raises RuntimeError on fail-fast death
        and CircuitOpen on an exhausted restart budget (both after
        halting the topology); restarts/watchdog kills are handled
        in-line. Returns a list of event strings for observability."""
        now = self._clock()
        events: list[str] = []
        fail_fast_dead = {}
        for tn, p in list(self._procs().items()):
            pol = self.policies[tn]
            st = self.state[tn]
            if st.down_since is not None:
                # awaiting respawn: keep the breaker clock honest
                if now >= st.next_restart_t:
                    events.append(f"restart {tn}")
                    self._restart(tn, now)
                continue
            if not p.is_alive():
                code = p.exitcode
                if code in (0, None) or self._cnc(tn).state == CNC_HALT:
                    continue             # clean exit: not a failure
                self._trace_mark(tn, EV_DOWN)
                self._dump_blackbox(tn, f"died (exit {code})")
                if pol["policy"] == "restart":
                    events.append(f"died {tn} (exit {code})")
                    self._mark_down(tn, now, code)
                else:
                    fail_fast_dead[tn] = code
                continue
            reason = self._watchdog_due(tn, now)
            if reason is not None:
                events.append(f"watchdog {tn}: {reason}")
                self._bump(tn, "sup_watchdog_trips")
                self._cnc(tn).state = CNC_FAIL
                self._kill(tn)
                # the wedged tile's final events, stamped with the trip,
                # before any restart reuses the ring
                self._trace_mark(tn, EV_WATCHDOG)
                self._dump_blackbox(tn, f"watchdog: {reason}")
                if pol["policy"] == "restart":
                    self._mark_down(tn, now, self._procs()[tn].exitcode)
                else:
                    fail_fast_dead[tn] = "wedged"
        if fail_fast_dead:
            self._halt_all()
            raise RuntimeError(
                f"tile process(es) died: {fail_fast_dead}")
        return events
