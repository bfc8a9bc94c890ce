"""fdtune: offline knob autotuning and the online adaptive controller
(copy of the JAX package's tune/__init__.py).

The knob space (coalesce windows, pack/bank waves, dispatch depths,
shed rates) has box-dependent knees. This package closes the loop in
two layers:

  * OFFLINE (tune/search.py, `python -m firedancer_tpu_torch.tune
    sweep`): a coordinate-descent sweep over the declared knob space,
    one topology boot per config point (tools/e2e.py's run on the
    card), checkpointed so a killed sweep resumes. Output: a tuned
    profile (tune/profile.py, JSON) that app/config.build_topology
    applies through FDTPU_TUNED_PROFILE.

  * ONLINE (tune/controller.py and the `controller` tile kind): a
    reader-side tile polls the shm metrics/SLO plane at housekeeping
    cadence and steers the runtime knob subset through the shm knob
    mailbox (runtime/tango.py::KnobMailbox, single writer), with
    per-knob hysteresis bands and cooldowns so it does not oscillate.
    Every decision is an EV_TUNE trace event and, through the flight
    recorder's trace keep list, an fdflight frame.

Config rides the topology as a `[tune]` section, validated at config
load (app/config.py) and at topo.build (the mailbox carve):

    [tune]
    enable = true
    interval_s = 0.25        # controller decision cadence floor
    cooldown_s = 2.0         # min seconds between moves of ONE knob
    recovery_s = 3.0         # calm time before reverting toward default
    hysteresis = 0.25        # dead band width around the act threshold
    max_moves = 4            # decision budget per rolling fast window
    window_s = 5.0           # the rolling window the budget covers
    bp_ref = 100.0           # backpressure ticks/sample ~ saturated

    [tune.knob.coalesce_us]  # optional per-knob bound overrides
    min = 0
    max = 2000
    step = 50

Disabled path: no [tune] section, or enable=false, means no mailbox
carve, no plan keys, and TileCtx.knobs stays None; steered adapters pay
one attribute check per housekeeping pass and nothing per frag.

Where the copy differs from the reference: the did-you-mean hint is the
port's difflib one (trace/recorder.py), not lint/registry.suggest
(fdlint, with its bad-tune rule and the mailbox's ownership catalog, is
ROADMAP.md queue A item 20).
"""
from __future__ import annotations

from ..trace.recorder import _suggest

# -- the knob catalog -------------------------------------------------------
# One entry per tunable. `runtime` knobs get a mailbox slot and are
# steered live by the controller; offline-only knobs (device shapes
# that require a reboot to change) exist for the sweep alone.
#   min/max/step/default: the integer search/steer domain
#   relief: the direction one step of pressure relief moves the knob
#   tiles: adapter kinds that read the knob (reader-side resolution)
KNOBS: dict[str, dict] = {
    "coalesce_us": {
        "min": 0, "max": 2000, "step": 100, "default": 200,
        "relief": +1, "runtime": True, "tiles": ("verify",),
        "doc": "verify microbatch hold window (us): widen under "
               "saturation so compiled batches dispatch full",
    },
    "verify_batch": {
        # floor 16: VerifyTile rejects batch < max sig_cnt (12), and
        # the domain must stay on the step-8 grid above it
        "min": 16, "max": 256, "step": 8, "default": 32,
        "relief": +1, "runtime": False, "tiles": ("verify",),
        "doc": "verify device batch (compiled shape — offline only)",
    },
    "pack_wave": {
        "min": 1, "max": 32, "step": 1, "default": 4,
        "relief": +1, "runtime": True, "tiles": ("pack",),
        "doc": "outstanding microblocks per bank (pack scheduler)",
    },
    "bank_wave": {
        "min": 1, "max": 32, "step": 1, "default": 8,
        "relief": +1, "runtime": True, "tiles": ("bank",),
        "doc": "microblocks per bank device wave",
    },
    "exec_dispatch": {
        "min": 1, "max": 64, "step": 1, "default": 8,
        "relief": +1, "runtime": True, "tiles": ("exec",),
        "doc": "exec-tile dispatch depth (frames gathered per poll)",
    },
    "bulk_prefilter": {
        "min": 0, "max": 1, "step": 1, "default": 0,
        "relief": +1, "runtime": True, "tiles": ("verify",),
        "doc": "arm the RLC bulk-prefilter's shed path under flood",
    },
    "shed_tighten": {
        "min": 0, "max": 8, "step": 1, "default": 0,
        "relief": +1, "runtime": True, "tiles": ("sock", "quic",
                                                 "gossip", "repair"),
        "doc": "front-door tightening level: per-peer admit rate "
               "scales down 1/(1+level)",
    },
}

# the mailbox slot order (the ABI): runtime knobs in catalog order
RUNTIME_KNOBS = tuple(n for n, s in KNOBS.items() if s["runtime"])

TUNE_DEFAULTS = {
    "enable": True,
    "interval_s": 0.25,
    "cooldown_s": 2.0,
    "recovery_s": 3.0,
    "hysteresis": 0.25,
    "max_moves": 4,
    "window_s": 5.0,
    "bp_ref": 100.0,
    "knob": {},
}
# per-knob override table keys ([tune.knob.<name>])
KNOB_KEYS = ("min", "max", "step", "default")


def normalize_tune(spec) -> dict:
    """Validate + default-fill a [tune] section. Returns a plain
    JSON-able dict; raises ValueError with a did-you-mean on typos —
    the same fail-before-launch stance as trace/slo/flight."""
    out = dict(TUNE_DEFAULTS)
    out["knob"] = {}
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"tune spec must be a table, got {spec!r}")
    unknown = set(spec) - set(TUNE_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown tune key(s) {sorted(unknown)}"
                         + _suggest(key, TUNE_DEFAULTS))
    out.update({k: v for k, v in spec.items() if k != "knob"})
    out["enable"] = bool(out["enable"])
    for k in ("interval_s", "cooldown_s", "recovery_s", "window_s",
              "bp_ref"):
        out[k] = float(out[k])
        if out[k] <= 0:
            raise ValueError(f"tune.{k} must be > 0, got {out[k]}")
    out["hysteresis"] = float(out["hysteresis"])
    if not 0 < out["hysteresis"] < 1:
        raise ValueError(f"tune.hysteresis must be in (0, 1), got "
                         f"{out['hysteresis']}")
    out["max_moves"] = int(out["max_moves"])
    if out["max_moves"] < 1:
        raise ValueError(f"tune.max_moves must be >= 1, got "
                         f"{out['max_moves']}")
    if out["cooldown_s"] < out["interval_s"]:
        # a cooldown shorter than the decision cadence is vacuous —
        # every pass could move every knob, the hysteresis proof dies
        raise ValueError("tune.cooldown_s must be >= interval_s")
    knobs = spec.get("knob", {})
    if not isinstance(knobs, dict):
        raise ValueError("[tune.knob.<name>] must be tables")
    for name, over in knobs.items():
        if name not in KNOBS:
            raise ValueError(f"unknown tune knob {name!r}"
                             + _suggest(name, KNOBS))
        if not isinstance(over, dict):
            raise ValueError(f"tune.knob.{name} must be a table, "
                             f"got {over!r}")
        unknown = set(over) - set(KNOB_KEYS)
        if unknown:
            key = sorted(unknown)[0]
            raise ValueError(
                f"tune.knob.{name}: unknown key(s) {sorted(unknown)}"
                + _suggest(key, KNOB_KEYS))
        merged = {k: int(over.get(k, KNOBS[name][k]))
                  for k in KNOB_KEYS}
        if merged["step"] <= 0:
            raise ValueError(f"tune.knob.{name}.step must be > 0")
        if merged["min"] > merged["max"]:
            raise ValueError(f"tune.knob.{name}: min {merged['min']} "
                             f"> max {merged['max']}")
        if not merged["min"] <= merged["default"] <= merged["max"]:
            raise ValueError(
                f"tune.knob.{name}: default {merged['default']} "
                f"outside [{merged['min']}, {merged['max']}]")
        out["knob"][name] = merged
    return out


def knob_space(cfg: dict | None) -> dict[str, dict]:
    """Resolved per-knob search/steer domain: the catalog merged with
    the normalized section's [tune.knob] overrides. Used by the
    offline sweep (all knobs) and the controller (runtime subset)."""
    cfg = cfg or {}
    over = cfg.get("knob", {})
    out = {}
    for name, spec in KNOBS.items():
        d = {k: int(spec[k]) for k in KNOB_KEYS}
        d.update(over.get(name, {}))
        d["relief"] = spec["relief"]
        d["runtime"] = spec["runtime"]
        d["tiles"] = spec["tiles"]
        out[name] = d
    return out


# -- reader side (the fdtrace disabled-path contract) -----------------------

class KnobReader:
    """One tile's read-side view of the mailbox: only the knobs its
    kind consumes, resolved once at join. `get` is the per-
    housekeeping call — one slot read per knob, value None until the
    controller has ever posted (config stays authoritative)."""

    def __init__(self, mailbox, knobs: dict[str, int]):
        self.mailbox = mailbox
        self.knobs = knobs                 # name -> slot index

    def get(self, name: str) -> int | None:
        idx = self.knobs.get(name)
        if idx is None:
            return None
        value, seq = self.mailbox.read(idx)
        return value if seq else None


def reader_for(plan: dict, wksp, tile_name: str) -> KnobReader | None:
    """None unless topo.build carved a knob mailbox AND this tile's
    kind consumes at least one runtime knob — the None IS the disabled
    fast path (one attribute check per housekeeping, nothing per
    frag)."""
    off = plan.get("tune_mailbox_off")
    names = plan.get("tune_knobs")
    if off is None or not names:
        return None
    kind = plan["tiles"][tile_name]["kind"]
    knobs = {n: i for i, n in enumerate(names)
             if kind in KNOBS.get(n, {}).get("tiles", ())}
    if not knobs:
        return None
    from ..runtime import KnobMailbox
    return KnobReader(KnobMailbox(wksp, off, len(names)), knobs)
