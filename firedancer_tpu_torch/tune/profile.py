"""Tuned profiles: the offline sweep's durable output (copy of the JAX
package's tune/profile.py; a profile saved by either package loads in
the other).

A profile is a /dev/shm-independent JSON artifact — host fingerprint
(provenance: WHICH box measured this knee), the winning knob vector,
and the measured knee (tuned vs default e2e tps) — written by
`python -m firedancer_tpu_torch.tune sweep` and loaded two ways:

  * FDTPU_TUNED_PROFILE=<path>: app/config.build_topology applies the
    profile's knob vector onto the topology's tile args before the
    build, so every launcher (TopologyRunner, app.run, app.dev) boots
    at the measured knee with zero per-site code.
  * `python -m firedancer_tpu_torch.tune profile show/diff`: the
    operator surface.

Where the copy differs from the reference: the host fingerprint reads
the device from torch (`backend` "cuda" or "cpu", `devices` from
torch.cuda.device_count(), and the card's name in `device_name`), where
the reference reads jax.

Static application maps each knob onto the tile args that seed it
(KNOB_ARGS below); runtime-only knobs with no boot-time arg (the shed
tightening level) are skipped — they exist for the online controller.
"""
from __future__ import annotations

import json
import os
import time

from . import KNOBS

PROFILE_VERSION = 1

# knob -> (tile kind, arg key) for static application; None = no
# boot-time arg (runtime-only, controller-steered)
KNOB_ARGS: dict[str, tuple[str, str] | None] = {
    "coalesce_us": ("verify", "coalesce_us"),
    "verify_batch": ("verify", "batch"),
    "pack_wave": ("pack", "wave"),
    "bank_wave": ("bank", "wave"),
    "exec_dispatch": ("exec", "batch"),
    "bulk_prefilter": ("verify", "prefilter_shed"),
    "shed_tighten": None,
}


def host_fingerprint() -> dict:
    """Where a profile was measured: enough to notice that a profile
    is being applied on a DIFFERENT box (a knee is hardware-shaped),
    cheap enough to stamp on every sweep checkpoint."""
    import platform
    fp = {
        "hostname": platform.node(),
        "machine": platform.machine(),
        "cpus": os.cpu_count(),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }
    try:
        import torch
        on_card = torch.cuda.is_available()
        fp["backend"] = "cuda" if on_card else "cpu"
        fp["devices"] = torch.cuda.device_count()
        fp["device_name"] = torch.cuda.get_device_name(0) \
            if on_card else None
    except Exception:        # noqa: BLE001 — profile tooling sans torch
        fp["backend"] = None
        fp["devices"] = 0
        fp["device_name"] = None
    return fp


def make_profile(knobs: dict, tuned_tps: float, default_tps: float,
                 sweep: dict | None = None) -> dict:
    unknown = set(knobs) - set(KNOBS)
    if unknown:
        raise ValueError(f"profile: unknown knob(s) {sorted(unknown)}")
    return {
        "fdtune_profile": PROFILE_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                    time.gmtime()),
        "host": host_fingerprint(),
        "knobs": {k: int(v) for k, v in knobs.items()},
        "measured": {
            "tuned_tps": float(tuned_tps),
            "default_tps": float(default_tps),
            "tuned_vs_default_tps": (float(tuned_tps) / default_tps
                                     if default_tps else 0.0),
        },
        "sweep": sweep or {},
    }


def save_profile(doc: dict, path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_profile(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or \
            doc.get("fdtune_profile") != PROFILE_VERSION:
        raise ValueError(
            f"{path}: not an fdtune profile (want fdtune_profile = "
            f"{PROFILE_VERSION}, got {doc.get('fdtune_profile')!r})")
    for key in ("host", "knobs", "measured"):
        if key not in doc:
            raise ValueError(f"{path}: profile missing {key!r}")
    unknown = set(doc["knobs"]) - set(KNOBS)
    if unknown:
        raise ValueError(
            f"{path}: profile names unknown knob(s) {sorted(unknown)}")
    return doc


def apply_profile(topo, doc: dict) -> list[tuple[str, str, int]]:
    """Seed an UNBUILT Topology's tile args from a profile's knob
    vector. Returns [(tile, arg, value)] for logging; knobs whose tile
    kind is absent from this topology (or that have no boot-time arg)
    apply to nothing, silently — a profile measured on the full topo
    must stay loadable by a bench slice."""
    applied: list[tuple[str, str, int]] = []
    for knob, value in doc["knobs"].items():
        target = KNOB_ARGS.get(knob)
        if target is None:
            continue
        kind, arg = target
        cast = bool if knob == "bulk_prefilter" else int
        for tn, t in topo.tiles.items():
            if t.kind != kind:
                continue
            if knob == "bulk_prefilter" and \
                    t.args.get("mode") != "bulk_prefilter":
                continue           # arming needs the prefilter wired
            t.args[arg] = cast(value)
            applied.append((tn, arg, int(value)))
    return applied


def diff_profiles(a: dict, b: dict) -> dict:
    """{knob: (a_value, b_value)} for every knob where they disagree
    (missing = that side's catalog default)."""
    out = {}
    for k in sorted(set(a["knobs"]) | set(b["knobs"])):
        av = a["knobs"].get(k, KNOBS[k]["default"])
        bv = b["knobs"].get(k, KNOBS[k]["default"])
        if av != bv:
            out[k] = (av, bv)
    return out
