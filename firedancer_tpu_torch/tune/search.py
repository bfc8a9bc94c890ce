"""fdtune offline search: find the knob vector's knee by measurement
(copy of the JAX package's tune/search.py; its state file is the
reference's JSON, so a sweep checkpointed by either package resumes in
the other).

Coordinate descent with a successive-halving flavor over the declared
knob space (tune/__init__.py KNOBS + [tune.knob] overrides): evaluate
the DEFAULT point first (so the winner can never lose to the shipped
config — tuned_vs_default_tps >= 1.0 by construction), then sweep one
axis at a time around the incumbent, then refine the winner one step
each way. Every point is one full topology boot through the injected
`bench` callable (tools/e2e.py's e2e_run, the port's copy of bench.py's
_e2e_run, on the real path: boot once per config point, never mutate a
hot topology mid-measurement).

Every measured point lands in a JSON checkpoint BEFORE the next boot,
so a killed sweep resumes exactly where it died: re-running with the
same state_path skips completed points.
"""
from __future__ import annotations

import json
import os

from . import knob_space

STATE_VERSION = 1

# knobs the synth->verify->dedup->sink bench topology can actually
# exercise; the others need the full leader loop and stay controller-
# only until the sweep grows a leader mode
DEFAULT_AXES = ("coalesce_us", "verify_batch")


def point_key(pt: dict) -> str:
    """Canonical checkpoint key for one config point."""
    return json.dumps({k: int(pt[k]) for k in sorted(pt)},
                      sort_keys=True, separators=(",", ":"))


def load_state(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"fdtune_sweep": STATE_VERSION, "points": {}}
    if doc.get("fdtune_sweep") != STATE_VERSION or \
            not isinstance(doc.get("points"), dict):
        return {"fdtune_sweep": STATE_VERSION, "points": {}}
    return doc


def save_state(path: str, state: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def axis_candidates(spec: dict, points: int = 5) -> list[int]:
    """Candidate values for one axis: the default, the bounds, and
    step-multiples spreading out from the default — deterministic, at
    most `points` values, always inside [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    d, step = int(spec["default"]), int(spec["step"])
    cand = [d, lo, hi]
    for k in (2, -2, 4, -4, 1, -1):
        cand.append(d + k * step)
    out: list[int] = []
    for v in cand:
        v = max(lo, min(hi, v))
        if v not in out:
            out.append(v)
        if len(out) >= points:
            break
    return out


def run_sweep(bench, state_path: str, cfg: dict | None = None,
              axes=DEFAULT_AXES, points: int = 5,
              log=lambda msg: None) -> dict:
    """The search loop. `bench(pt) -> tps` measures one config point
    (a {knob: value} dict over `axes`) with one topology boot; any
    exception it raises aborts the sweep WITH the checkpoint intact.
    Returns {knobs, tuned_tps, default_tps, tuned_vs_default_tps,
    points, measured} — profile-ready via tune.profile.make_profile."""
    space = knob_space(cfg)
    for a in axes:
        if a not in space:
            raise ValueError(f"sweep: unknown knob axis {a!r}")
    state = load_state(state_path)
    measured = 0

    def measure(pt: dict) -> float:
        nonlocal measured
        key = point_key(pt)
        hit = state["points"].get(key)
        if hit is not None:
            log(f"cached  {key} -> {hit}")
            return float(hit)
        tps = float(bench(dict(pt)))
        state["points"][key] = tps
        save_state(state_path, state)     # land BEFORE the next boot
        measured += 1
        log(f"measured {key} -> {tps}")
        return tps

    default_pt = {a: int(space[a]["default"]) for a in axes}
    default_tps = measure(default_pt)
    best_pt, best_tps = dict(default_pt), default_tps

    # coordinate descent: sweep each axis around the incumbent; a pass
    # with no improvement terminates (two passes bound the budget)
    for _ in range(2):
        improved = False
        for a in axes:
            for v in axis_candidates(space[a], points):
                if v == best_pt[a]:
                    continue
                pt = dict(best_pt)
                pt[a] = v
                tps = measure(pt)
                if tps > best_tps:
                    best_pt, best_tps = pt, tps
                    improved = True
        if not improved:
            break

    # refinement: one step each way off the winner, per axis — the
    # "halved" fine stage of the coarse/fine schedule
    for a in axes:
        s = space[a]
        for v in (best_pt[a] - s["step"], best_pt[a] + s["step"]):
            v = max(s["min"], min(s["max"], int(v)))
            if v == best_pt[a]:
                continue
            pt = dict(best_pt)
            pt[a] = v
            tps = measure(pt)
            if tps > best_tps:
                best_pt, best_tps = pt, tps

    return {
        "knobs": best_pt,
        "tuned_tps": best_tps,
        "default_tps": default_tps,
        # >= 1.0 by construction: the default point is in the argmax
        "tuned_vs_default_tps": (best_tps / default_tps
                                 if default_tps else 0.0),
        "points": len(state["points"]),
        "measured": measured,
        "state_path": state_path,
    }
