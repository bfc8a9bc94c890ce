"""SLO engine: declarative service-level objectives over the shm
metrics plane, evaluated with fast/slow burn-rate windows.

The reference's posture is that the metrics plane must answer "are we
meeting the objective" without a sidecar stack: the metric tile owns
exposition (fd_metric_tile.c), and alerting-grade roll-ups belong next
to it. Here a validated `[slo]` topology section declares objectives
as one-line expressions over the SAME shm regions every other reader
uses (tile metric slots, wait/work/tpu histograms, per-link telemetry
blocks), and the metric tile evaluates them at its housekeeping
cadence — reader-side only, so the engine survives any tile's death.

Expression grammar (one line per target):

    <source> [<agg>] <op> <threshold>

    source   <tile>.<metric>          a named tile metric slot
             <tile>.<hist>            wait | work | tpu histogram
             link.<link>.<counter>    per-link telemetry (consumer
                                      counters are summed across the
                                      link's consumers)
    agg      value (default) | rate (per second, from the counter's
             delta between samples) | p50 | p90 | p99 (histogram
             quantile, duration threshold)
    op       < | <= | > | >=
    threshold  float, with ns/us/ms/s for durations or /s for rates

    examples:  verify.work p99 < 500us
               sink.rx rate > 1000/s
               link.verify_dedup.backpressure rate < 1/s

The expression states the OBJECTIVE (the good condition); a sample is
"bad" when it does not hold. Burn-rate evaluation uses two windows
(the SRE multi-window pattern): a breach fires when the bad-sample
fraction reaches `burn_fast` over `fast_window_s` (sustained acute
violation — the page) or `burn_slow` over `slow_window_s` (chronic
budget burn); it clears when the fast window is clean and the slow
window is back under its burn. On a breach transition the engine
flips the metric tile's `slo_breach` gauge, records an EV_SLO trace
event in the metric tile's flight-recorder ring, and dumps a JSON
snapshot next to the supervisor's black boxes
(/dev/shm/fdtt_<topo>.slo.<target>.json).

Config schema ([slo] section / Topology(slo=...)):

    [slo]
    fast_window_s = 5.0
    slow_window_s = 60.0
    burn_fast = 1.0          # bad fraction over the fast window
    burn_slow = 0.5          # bad fraction over the slow window

    [[slo.target]]
    name = "verify-latency"
    expr = "verify.work p99 < 500us"
    fast_window_s = 2.0      # optional per-target overrides

Validated at config load (app/config.py) and at topo.build (targets
must resolve against the declared tiles/metrics/links).

Copy of the JAX package's disco/slo.py, with PressureProbe (the ingest
doors' overload roll-up, disco/shed.py imports it from here); where it
differs: breach dumps follow the port's shm prefix
(/dev/shm/fdtt_<topo>.slo.<target>.json, where the reference writes
`fdtpu_`), the did-you-mean hint is a few lines of difflib (the
reference's lint/registry.suggest; fdlint, whose bad-slo rule shares
check_target, is not ported), and nothing but the metric tile reads
`SloEngine.pressure` (the fdtune controller is ROADMAP.md queue A item
11).
"""
from __future__ import annotations

import difflib
import json
import re
import time
from collections import deque

SLO_DEFAULTS = {
    "fast_window_s": 5.0,
    "slow_window_s": 60.0,
    "burn_fast": 1.0,
    "burn_slow": 0.5,
    "target": [],
}
TARGET_KEYS = ("name", "expr", "fast_window_s", "slow_window_s",
               "burn_fast", "burn_slow")

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}
_QUANTILES = {"p50": 0.50, "p90": 0.90, "p99": 0.99}
_AGGS = ("value", "rate", *_QUANTILES)
_UNITS_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000}
_THRESH_RE = re.compile(r"^([0-9]+(?:\.[0-9]+)?)(ns|us|ms|s|/s)?$")


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(str(key), sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_slo(spec) -> dict:
    """Validate + default-fill an [slo] section. Returns a plain
    JSON-able dict (targets carry their parsed expression under
    `parsed`); raises ValueError with a did-you-mean on typos — the
    same fail-before-launch stance as supervise/trace."""
    out = dict(SLO_DEFAULTS)
    out["target"] = []
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"slo spec must be a table, got {spec!r}")
    unknown = set(spec) - set(SLO_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown slo key(s) {sorted(unknown)}"
                         + _suggest(key, SLO_DEFAULTS))
    out.update({k: v for k, v in spec.items() if k != "target"})
    for k in ("fast_window_s", "slow_window_s"):
        out[k] = float(out[k])
        if out[k] <= 0:
            raise ValueError(f"slo.{k} must be > 0")
    for k in ("burn_fast", "burn_slow"):
        out[k] = float(out[k])
        if not 0 < out[k] <= 1:
            raise ValueError(f"slo.{k} must be in (0, 1]")
    if out["fast_window_s"] > out["slow_window_s"]:
        # sample history is pruned to the slow window, so a fast
        # window beyond it can never be covered — the acute breach
        # path would be silently dead
        raise ValueError("slo.fast_window_s must be <= slow_window_s")
    targets = spec.get("target", [])
    if not isinstance(targets, (list, tuple)):
        raise ValueError("[[slo.target]] must be an array of tables")
    names = set()
    for t in targets:
        if not isinstance(t, dict):
            raise ValueError(f"slo target must be a table, got {t!r}")
        unknown = set(t) - set(TARGET_KEYS)
        if unknown:
            key = sorted(unknown)[0]
            raise ValueError(
                f"slo target: unknown key(s) {sorted(unknown)}"
                + _suggest(key, TARGET_KEYS))
        if not isinstance(t.get("name"), str) or not t["name"]:
            raise ValueError(f"slo target missing 'name': {t!r}")
        if t["name"] in names:
            raise ValueError(f"duplicate slo target {t['name']!r}")
        names.add(t["name"])
        if not isinstance(t.get("expr"), str):
            raise ValueError(f"slo target {t['name']!r} missing 'expr'")
        norm = dict(t)
        norm["parsed"] = parse_expr(t["expr"])
        # per-target overrides pass the SAME range gates as the
        # section-level defaults — an out-of-range burn (e.g. 1.5, a
        # fraction that can never be reached) would otherwise make the
        # objective silently unmonitorable
        for k in ("fast_window_s", "slow_window_s"):
            norm[k] = float(norm.get(k, out[k]))
            if norm[k] <= 0:
                raise ValueError(
                    f"slo target {t['name']!r}: {k} must be > 0")
        for k in ("burn_fast", "burn_slow"):
            norm[k] = float(norm.get(k, out[k]))
            if not 0 < norm[k] <= 1:
                raise ValueError(
                    f"slo target {t['name']!r}: {k} must be in (0, 1]")
        if norm["fast_window_s"] > norm["slow_window_s"]:
            raise ValueError(
                f"slo target {t['name']!r}: fast_window_s must be "
                f"<= slow_window_s")
        out["target"].append(norm)
    return out


def parse_expr(expr: str) -> dict:
    """One objective expression -> a plain parsed dict (JSON-able, it
    rides in the plan). Raises ValueError on bad grammar."""
    toks = expr.split()
    if len(toks) == 3:
        src, agg, (op, thresh) = toks[0], "value", toks[1:]
    elif len(toks) == 4:
        src, agg, op, thresh = toks
    else:
        raise ValueError(
            f"slo expr {expr!r}: want '<source> [agg] <op> "
            f"<threshold>'")
    if agg not in _AGGS:
        raise ValueError(f"slo expr {expr!r}: unknown aggregation "
                         f"{agg!r}" + _suggest(agg, _AGGS))
    if op not in _OPS:
        raise ValueError(f"slo expr {expr!r}: unknown operator {op!r}")
    m = _THRESH_RE.match(thresh)
    if not m:
        raise ValueError(f"slo expr {expr!r}: bad threshold "
                         f"{thresh!r} (float + ns/us/ms/s or /s)")
    value, unit = float(m.group(1)), m.group(2)
    if agg in _QUANTILES:
        if unit == "/s" or unit is None:
            raise ValueError(
                f"slo expr {expr!r}: quantile thresholds take a "
                f"duration unit (ns/us/ms/s)")
        value *= _UNITS_NS[unit]          # quantiles compare in ns
    elif unit == "/s":
        if agg != "rate":
            raise ValueError(
                f"slo expr {expr!r}: '/s' threshold needs the rate "
                f"aggregation")
    elif unit is not None:
        raise ValueError(
            f"slo expr {expr!r}: duration unit {unit!r} only applies "
            f"to quantile aggregations")
    parts = src.split(".")
    if parts[0] == "link":
        if len(parts) != 3:
            raise ValueError(
                f"slo expr {expr!r}: link source is "
                f"'link.<link>.<counter>'")
        if agg in _QUANTILES:
            raise ValueError(
                f"slo expr {expr!r}: link counters have no quantiles "
                f"(use value or rate)")
        return {"kind": "link", "link": parts[1], "counter": parts[2],
                "agg": agg, "op": op, "threshold": value}
    if len(parts) != 2:
        raise ValueError(
            f"slo expr {expr!r}: tile source is '<tile>.<metric>' or "
            f"'<tile>.<wait|work|tpu>'")
    if agg in _QUANTILES:
        return {"kind": "hist", "tile": parts[0], "hist": parts[1],
                "agg": agg, "op": op, "threshold": value}
    return {"kind": "metric", "tile": parts[0], "metric": parts[1],
            "agg": agg, "op": op, "threshold": value}


def check_target(parsed: dict, tiles: dict, links) -> str | None:
    """Resolve one parsed source against the topology's declared
    surface: tiles = {tile_name: [metric slot names]}, links = link
    names. Returns an error string (with did-you-mean) or None;
    topo.build fails the build on it."""
    from .metrics import (HIST_KINDS, LINK_CONS_COUNTERS,
                          LINK_PROD_COUNTERS)
    from .supervise import SUP_SLOTS
    if parsed["kind"] == "link":
        if parsed["link"] not in links:
            return (f"unknown link {parsed['link']!r}"
                    + _suggest(parsed["link"], links))
        known = LINK_PROD_COUNTERS + LINK_CONS_COUNTERS
        if parsed["counter"] not in known:
            return (f"unknown link counter {parsed['counter']!r}"
                    + _suggest(parsed["counter"], known))
        return None
    if parsed["tile"] not in tiles:
        return (f"unknown tile {parsed['tile']!r}"
                + _suggest(parsed["tile"], tiles))
    if parsed["kind"] == "hist":
        if parsed["hist"] not in HIST_KINDS:
            return (f"unknown histogram {parsed['hist']!r}"
                    + _suggest(parsed["hist"], HIST_KINDS))
        return None
    known = list(tiles[parsed["tile"]]) + list(SUP_SLOTS)
    if parsed["metric"] not in known:
        return (f"tile {parsed['tile']!r} has no metric "
                f"{parsed['metric']!r}"
                + _suggest(parsed["metric"], known))
    return None


def resolve_slo(cfg: dict, plan: dict):
    """Resolve every normalized target against a built plan; raises
    ValueError on the first dangling reference."""
    tiles = {tn: spec.get("metrics_names", [])
             for tn, spec in plan["tiles"].items()}
    links = set(plan["links"])
    for t in cfg["target"]:
        err = check_target(t["parsed"], tiles, links)
        if err:
            raise ValueError(f"slo target {t['name']!r}: {err}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def slo_dump_path(topology: str, target: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", target)
    return f"/dev/shm/fdtt_{topology}.slo.{safe}.json"


class _TargetState:
    __slots__ = ("spec", "parsed", "flags", "bad_total", "raw",
                 "breached", "breaches", "since", "value", "fast_frac",
                 "slow_frac")

    def __init__(self, spec: dict):
        self.spec = spec
        self.parsed = spec["parsed"]
        self.flags: deque = deque()     # (t, bad) samples
        self.bad_total = 0              # running sum over flags
        self.raw: deque = deque()       # (t, counter) for rate
        self.breached = False
        self.breaches = 0
        self.since: float | None = None
        self.value: float | None = None
        self.fast_frac = 0.0
        self.slow_frac = 0.0


class SloEngine:
    """Burn-rate evaluation over the shm metrics plane. Reader-side
    only: constructed from (plan, joined wksp), typically inside the
    metric tile; `sample()` is called at the housekeeping cadence and
    returns breach/clear transition events. A TraceWriter (the metric
    tile's flight-recorder ring) makes every breach leave an EV_SLO
    record; `dump=True` additionally snapshots breaches to
    /dev/shm next to the supervisor black boxes."""

    def __init__(self, plan: dict, wksp, clock=time.monotonic,
                 trace=None, dump: bool = True):
        self.plan, self.wksp = plan, wksp
        self.clock = clock
        self.trace = trace
        self.dump = dump
        cfg = plan.get("slo") or dict(SLO_DEFAULTS, target=[])
        self.targets = [_TargetState(t) for t in cfg["target"]]
        self.evals = 0
        # breach history ring: the last N breach/clear transitions,
        # exposed via /summary.json so a FLAPPING objective is visible
        # without grepping dump files (each EV_SLO in the trace ring
        # has a matching row here with the measured value and fracs)
        self.history: deque = deque(maxlen=64)

    # -- source readers -----------------------------------------------------

    def _read(self, st: _TargetState, now: float) -> float | None:
        """Current value of a target's source (None = not measurable
        yet, e.g. a rate's first sample or an empty histogram)."""
        from . import topo as topo_mod
        from .metrics import quantile_ns, read_hists, read_link_metrics
        from .supervise import SUP_SLOTS, sup_counters
        p = st.parsed
        if p["kind"] == "hist":
            h = read_hists(self.wksp, self.plan, p["tile"]).get(
                p["hist"])
            if not h or not h["count"]:
                return None
            return float(quantile_ns(h, _QUANTILES[p["agg"]]))
        if p["kind"] == "link":
            rec = read_link_metrics(self.wksp, self.plan,
                                    links=(p["link"],)).get(p["link"])
            if rec is None:
                return None
            if p["counter"] in rec:
                raw = float(rec[p["counter"]])
            else:
                raw = float(sum(c[p["counter"]]
                                for c in rec["consumers"].values()))
        else:
            spec = self.plan["tiles"][p["tile"]]
            vals = topo_mod.read_metrics(self.wksp, self.plan,
                                         p["tile"])
            names = spec.get("metrics_names", [])
            if p["metric"] in names:
                raw = float(vals[names.index(p["metric"])])
            elif p["metric"] in SUP_SLOTS:
                raw = float(sup_counters(vals)[p["metric"]])
            else:
                return None
        if p["agg"] != "rate":
            return raw
        # rate over the target's FAST window, not between adjacent
        # samples: the engine samples faster than writers flush their
        # shm blocks (the stem's housekeeping cadence), so a
        # consecutive-sample rate reads spurious zeros whenever two
        # engine passes land inside one flush interval
        st.raw.append((now, raw))
        lo = now - st.spec["fast_window_s"]
        while len(st.raw) > 1 and st.raw[1][0] <= lo:
            st.raw.popleft()      # keep one sample at the window edge
        t0, v0 = st.raw[0]
        if now <= t0:
            return None           # first sample: no horizon yet
        return (raw - v0) / (now - t0)

    # -- burn-rate evaluation -----------------------------------------------

    def _fast_frac(self, st: _TargetState, now: float,
                   window: float) -> float:
        """Bad fraction over [now-window, now]. Scans newest-first and
        stops at the window edge: the fast window is a small suffix of
        the (slow-window-sized) sample history. Coverage — whether the
        history actually spans the window, so a freshly booted engine
        cannot breach off two samples — is the CALLER's job, from the
        pre-prune oldest timestamp: after sample() prunes to the slow
        window, the surviving oldest can never predate now - fast_w
        when fast_window_s == slow_window_s, which would leave the
        acute breach path silently dead."""
        lo = now - window
        n = bad = 0
        for t, b in reversed(st.flags):
            if t < lo:
                break
            n += 1
            bad += b
        return bad / n if n else 0.0

    def sample(self) -> list[dict]:
        """One evaluation pass; returns breach/clear transitions."""
        now = self.clock()
        self.evals += 1
        events: list[dict] = []
        for idx, st in enumerate(self.targets):
            spec, p = st.spec, st.parsed
            value = self._read(st, now)
            st.value = value
            if value is None:
                continue                 # not measurable: no sample
            bad = not _OPS[p["op"]](value, p["threshold"])
            st.flags.append((now, bad))
            st.bad_total += bad
            slow_w = spec["slow_window_s"]
            # window coverage from the PRE-prune oldest sample: both
            # windows share it, and the post-prune oldest is >=
            # now - slow_w by construction, which would make fast
            # coverage unreachable when fast_window_s == slow_window_s
            oldest = st.flags[0][0]
            slow_cov = oldest <= now - slow_w
            fast_cov = oldest <= now - spec["fast_window_s"]
            while st.flags and st.flags[0][0] < now - slow_w:
                st.bad_total -= st.flags.popleft()[1]
            st.fast_frac = self._fast_frac(
                st, now, spec["fast_window_s"])
            # slow window == the whole retained history: O(1) running
            # sum instead of a rescan every evaluation pass
            st.slow_frac = st.bad_total / len(st.flags) if st.flags \
                else 0.0
            breach = (fast_cov and st.fast_frac >= spec["burn_fast"]) \
                or (slow_cov and st.slow_frac >= spec["burn_slow"])
            if breach and not st.breached:
                st.breached = True
                st.breaches += 1
                st.since = now
                events.append(self._transition(st, idx, "breach"))
            elif st.breached and st.fast_frac == 0.0 \
                    and st.slow_frac < spec["burn_slow"]:
                st.breached = False
                st.since = None
                events.append(self._transition(st, idx, "clear"))
        return events

    def _transition(self, st: _TargetState, idx: int,
                    kind: str) -> dict:
        ev = {"target": st.spec["name"], "expr": st.spec["expr"],
              "kind": kind, "value": st.value,
              "fast_frac": st.fast_frac, "slow_frac": st.slow_frac}
        self.history.append({"t": self.clock(), "kind": kind,
                             "target": st.spec["name"],
                             "value": st.value,
                             "breaches": st.breaches})
        if kind == "breach":
            if self.trace is not None:
                from ..trace.events import EV_SLO
                # arg carries the measured value (clamped to u64 —
                # durations are already integral ns), count the target
                # index so a drained ring names the objective
                self.trace.event(EV_SLO,
                                 arg=max(0, int(st.value or 0)),
                                 count=idx)
        if self.dump:
            # both edges dump (clear included, with the kind field), so
            # the files hold every breach and clear transition
            ev["dump"] = self._dump(st, kind)
        return ev

    def _dump(self, st: _TargetState, kind: str = "breach") -> str | None:
        """Breach/clear snapshot next to the supervisor black boxes —
        the post-mortem artifact: which objective, what value, how the
        windows looked. Must never block evaluation."""
        from ..utils.tempo import monotonic_ns
        path = slo_dump_path(self.plan.get("topology", "?"),
                             st.spec["name"])
        doc = {
            "topology": self.plan.get("topology", "?"),
            "kind": kind,
            "dumped_at_ns": monotonic_ns(),
            "target": st.spec["name"],
            "expr": st.spec["expr"],
            "value": st.value,
            "threshold": st.parsed["threshold"],
            "fast_frac": st.fast_frac,
            "slow_frac": st.slow_frac,
            "fast_window_s": st.spec["fast_window_s"],
            "slow_window_s": st.spec["slow_window_s"],
            "breaches": st.breaches,
            "samples": [[t, int(b)] for t, b in list(st.flags)[-256:]],
        }
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            return None
        return path

    # -- reader surface -----------------------------------------------------

    @property
    def breached(self) -> int:
        """Currently-breached target count (the slo_breach gauge)."""
        return sum(1 for st in self.targets if st.breached)

    @property
    def total_breaches(self) -> int:
        return sum(st.breaches for st in self.targets)

    def status(self) -> dict:
        """{target: {expr, breached, value, fracs, breaches}} — the
        /summary.json + monitor surface."""
        return {
            st.spec["name"]: {
                "expr": st.spec["expr"],
                "breached": st.breached,
                "value": st.value,
                "fast_frac": round(st.fast_frac, 4),
                "slow_frac": round(st.slow_frac, 4),
                "breaches": st.breaches,
                "since": st.since,
            } for st in self.targets
        }

    def pressure(self) -> dict:
        """The shared pressure roll-up (same shape as
        PressureProbe.poll), from the engine's own state — the metric
        tile gets the true fast-window burn fraction instead of the
        cross-process breach-counter approximation."""
        if getattr(self, "_probe", None) is None:
            self._probe = PressureProbe(self.plan, self.wksp)
        bp_delta, worst = self._probe.link_pressure()
        breached = self.breached
        return {"breached": breached,
                "burn": max((st.fast_frac for st in self.targets),
                            default=0.0),
                "bp_delta": bp_delta, "worst_link": worst,
                "overloaded": bool(breached)}


# ---------------------------------------------------------------------------
# the cross-process pressure roll-up (fdtune / shed overload coupling)
# ---------------------------------------------------------------------------

class PressureProbe:
    """ONE definition of \"the topology is under pressure\", readable
    from any tile at housekeeping cadence: the metric tile's
    slo_breach gauge (is any objective burning NOW), the slo_breaches
    counter delta (did a breach edge land since the last poll — the
    cross-process burn approximation), and the worst per-link producer
    backpressure delta with its link name (WHERE the topology is
    saturating). The ingest doors poll it (disco/tiles._shed_slo_poll);
    the reference's fdtune controller reads the same roll-up (item 11),
    so \"overloaded\" will mean the same thing to both."""

    def __init__(self, plan: dict, wksp):
        self.plan, self.wksp = plan, wksp
        self._metric_tile = None
        self._breach_idx = self._breaches_idx = None
        for tn, spec in plan.get("tiles", {}).items():
            if spec.get("kind") != "metric":
                continue
            names = spec.get("metrics_names", [])
            if "slo_breach" in names and "slo_breaches" in names:
                self._metric_tile = tn
                self._breach_idx = names.index("slo_breach")
                self._breaches_idx = names.index("slo_breaches")
                break
        self._link_offs = {
            ln: li["prod_metrics_off"]
            for ln, li in plan.get("links", {}).items()
            if li.get("prod_metrics_off") is not None}
        self._last_bp: dict[str, int] = {}
        self._last_breaches: int | None = None

    def _gauge(self) -> tuple[int, int]:
        """(slo_breach gauge, slo_breaches counter) — (0, 0) when the
        topology has no metric tile / no SLO engine."""
        if self._metric_tile is None:
            return 0, 0
        from . import topo as topo_mod
        try:
            vals = topo_mod.read_metrics(self.wksp, self.plan,
                                         self._metric_tile)
            return (int(vals[self._breach_idx]),
                    int(vals[self._breaches_idx]))
        except Exception:        # noqa: BLE001 — teardown race
            return 0, 0

    def link_pressure(self) -> tuple[int, str | None]:
        """(worst per-link producer-backpressure delta since the last
        poll, that link's name) — the saturating-hop attribution."""
        import numpy as np
        from .metrics import LINK_PROD_COUNTERS, LINK_PROD_U64
        bp_i = LINK_PROD_COUNTERS.index("backpressure")
        worst_delta, worst_link = 0, None
        for ln, off in self._link_offs.items():
            try:
                raw = self.wksp.view(off, LINK_PROD_U64 * 8) \
                    .view(np.uint64).copy()
            except Exception:    # noqa: BLE001 — teardown race
                continue
            bp = int(raw[bp_i])
            delta = bp - self._last_bp.get(ln, bp)
            self._last_bp[ln] = bp
            if delta > worst_delta:
                worst_delta, worst_link = delta, ln
        return worst_delta, worst_link

    def overloaded(self) -> bool:
        """The cheap form for ingest-door polling: is any objective
        burning right now (one metric-tile read, no link scan)."""
        return self._gauge()[0] > 0

    def poll(self) -> dict:
        """One pressure sample: {breached, burn, bp_delta, worst_link,
        overloaded}. `burn` is 1.0 when a breach edge landed since the
        last poll (new slo_breaches), else 0 — the cross-process
        approximation of the engine's fast-window fraction."""
        breached, breaches = self._gauge()
        burn = 0.0
        if self._last_breaches is not None and \
                breaches > self._last_breaches:
            burn = 1.0
        self._last_breaches = breaches
        bp_delta, worst = self.link_pressure()
        return {"breached": breached, "burn": burn,
                "bp_delta": bp_delta, "worst_link": worst,
                "overloaded": bool(breached)}
