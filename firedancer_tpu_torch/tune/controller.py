"""fdtune online controller: hold the topology at its measured knee
(copy of the JAX package's tune/controller.py).

One decision loop, run from the `controller` tile's housekeeping: poll
the shared pressure roll-up (disco/slo.py PressureProbe — SLO breach
gauge, burn edge, worst-link backpressure delta), fold it to a scalar
pressure in [0, 1], and steer the runtime knob subset through the shm
knob mailbox. The controller is the mailbox's SINGLE writer (the
reference's lint/ownership.py catalogs it as "knob-mailbox"; fdlint is
ROADMAP.md queue A item 20); steered adapters only read.

Non-oscillation by construction, not by tuning luck:

  * hysteresis dead band: relief engages only at pressure >= act_hi
    and reverting only at pressure <= act_lo, with
    act_hi - act_lo = cfg["hysteresis"] — a pressure signal sitting
    anywhere inside the band moves nothing, so there is no limit
    cycle around a threshold.
  * per-knob cooldown: one knob moves at most once per cooldown_s
    (>= interval_s by schema), so a knob can never flap within a
    decision interval.
  * recovery dwell: reverting toward defaults starts only after
    recovery_s of CONTINUOUS calm — one pressure blip resets the
    dwell, so relief is sticky under a flapping flood.
  * decision budget: at most max_moves knob posts per rolling
    window_s, total, escalate and revert combined — the hard bound
    tests/test_torch_tune.py holds to the reference's under scripted
    step loads and floods.

Every accepted move is an EV_TUNE trace record (arg = new value,
count = knob slot index, link = the saturating hop) and, through the
flight recorder's trace keep list, a durable fdflight frame.
"""
from __future__ import annotations

import time
from collections import deque

from . import knob_space, normalize_tune
from ..utils.tempo import monotonic_ns


class Controller:
    """The decision loop. Pure-host state machine over (plan, wksp):
    construct once in the controller tile, call `poll()` at
    housekeeping cadence — it self-paces to cfg["interval_s"] and
    returns the list of decisions it posted (empty almost always).
    `clock` is injectable so the hysteresis proofs run on a scripted
    clock, and `probe` so tests can feed synthetic pressure."""

    def __init__(self, plan: dict, wksp, cfg: dict | None = None,
                 clock=time.monotonic, trace=None, probe=None):
        self.plan = plan
        self.cfg = normalize_tune(cfg if cfg is not None
                                  else plan.get("tune"))
        names = plan.get("tune_knobs")
        off = plan.get("tune_mailbox_off")
        if not names or off is None:
            raise ValueError(
                "controller: plan carries no knob mailbox — [tune] "
                "must be enabled when the topology was built")
        self.names = list(names)
        self._slot = {n: i for i, n in enumerate(self.names)}
        space = knob_space(self.cfg)
        self.space = {n: space[n] for n in self.names}
        from ..runtime import KnobMailbox
        self.mailbox = KnobMailbox(wksp, off, len(self.names))
        if probe is None:
            from ..disco.slo import PressureProbe
            probe = PressureProbe(plan, wksp)
        self.probe = probe
        self.clock = clock
        self.trace = trace
        # thresholds: the dead band is centered on 1/2 and exactly
        # cfg["hysteresis"] wide, clamped so both stay in (0, 1)
        h = self.cfg["hysteresis"] / 2.0
        self.act_hi = min(0.999, 0.5 + h)
        self.act_lo = max(0.001, 0.5 - h)
        # steered values start at the per-knob defaults; the mailbox
        # stays unposted (seq 0) until the first decision, so adapter
        # config remains authoritative until the controller speaks
        self.value = {n: self.space[n]["default"] for n in self.names}
        self._last_move: dict[str, float] = {}
        self._calm_since: float | None = None
        self._moves: deque = deque()        # decision ts, window budget
        self._next_poll = float("-inf")
        self.decisions = 0
        self.reverts = 0
        self.pressure = 0.0
        self.last = {"breached": 0, "burn": 0.0, "bp_delta": 0,
                     "worst_link": None, "overloaded": False}

    # -- pressure folding ---------------------------------------------------

    def _fold(self, p: dict) -> float:
        """Pressure sample -> scalar in [0, 1]: a burning objective or
        a fresh breach edge is saturation by definition (1.0);
        otherwise backpressure ticks against bp_ref, the 'one full
        window of producer stalls per poll' reference."""
        if p["breached"] or p["burn"] >= 1.0:
            return 1.0
        return min(1.0, p["bp_delta"] / self.cfg["bp_ref"])

    # -- the decision pass --------------------------------------------------

    def poll(self, now: float | None = None) -> list[dict]:
        if now is None:
            now = self.clock()
        if now < self._next_poll:
            return []
        self._next_poll = now + self.cfg["interval_s"]
        p = self.probe.poll()
        self.last = p
        self.pressure = self._fold(p)
        lo = now - self.cfg["window_s"]
        while self._moves and self._moves[0] <= lo:
            self._moves.popleft()
        if self.pressure >= self.act_hi:
            self._calm_since = None
            return self._steer(now, p, relief=True)
        if self.pressure <= self.act_lo:
            if self._calm_since is None:
                self._calm_since = now
            if now - self._calm_since >= self.cfg["recovery_s"]:
                return self._steer(now, p, relief=False)
            return []
        # inside the dead band: hold everything, reset nothing — calm
        # accrued so far survives a sub-threshold wobble
        return []

    def _steer(self, now: float, p: dict, relief: bool) -> list[dict]:
        """One step per eligible knob: toward relief under pressure,
        toward the default during recovery. Both directions pay the
        same per-knob cooldown and the same shared window budget."""
        out = []
        for n in self.names:
            if len(self._moves) >= self.cfg["max_moves"]:
                break
            s = self.space[n]
            last = self._last_move.get(n)
            if last is not None and now - last < self.cfg["cooldown_s"]:
                continue
            cur = self.value[n]
            if relief:
                nv = cur + s["relief"] * s["step"]
            elif cur == s["default"]:
                continue
            else:
                step = s["step"] if cur < s["default"] else -s["step"]
                nv = cur + step
                # never overshoot the default from either side
                if (step > 0) == (nv > s["default"]):
                    nv = s["default"]
            nv = max(s["min"], min(s["max"], int(nv)))
            if nv == cur:
                continue
            out.append(self._post(n, nv, now, p, relief))
        return out

    def _post(self, name: str, value: int, now: float, p: dict,
              relief: bool) -> dict:
        idx = self._slot[name]
        self.value[name] = value
        self.mailbox.post(idx, value, ts_ns=monotonic_ns())
        self._last_move[name] = now
        self._moves.append(now)
        self.decisions += 1
        if not relief:
            self.reverts += 1
        link = p.get("worst_link")
        if self.trace is not None:
            from ..runtime import TRACE_LINK_NONE
            from ..trace.events import EV_TUNE
            self.trace.event(
                EV_TUNE, arg=value, count=idx,
                link=(self.trace.link_id(link) if link
                      else TRACE_LINK_NONE))
        return {"t": now, "knob": name, "value": value,
                "why": "relief" if relief else "revert",
                "pressure": round(self.pressure, 4),
                "worst_link": link}

    # -- reader surface -----------------------------------------------------

    def status(self) -> dict:
        """The tuning-panel document (fdgui's, ROADMAP.md queue A item
        9, in the reference): current steered values vs defaults,
        pressure, budget occupancy, last sample."""
        return {
            "pressure": round(self.pressure, 4),
            "decisions": self.decisions,
            "reverts": self.reverts,
            "moves_in_window": len(self._moves),
            "max_moves": self.cfg["max_moves"],
            "last": dict(self.last),
            "knobs": {n: {"value": self.value[n],
                          "default": self.space[n]["default"],
                          "steered":
                              self.value[n] != self.space[n]["default"]}
                      for n in self.names},
        }
