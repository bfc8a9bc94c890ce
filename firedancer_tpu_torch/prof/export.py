"""fdprof export: shm profile regions and fdtrace rings -> one merged
Perfetto bundle, folded-stack text and top-k summaries (copy of the JAX
package's prof/export.py).

The merge is the point: fdtrace spans (wait/work/tpu_dispatch/...), the
host sampler's timestamped ring and the device capture's kernel events
all carry `utils/tempo.monotonic_ns` timestamps, one clock domain, so the
bundle interleaves them on one Perfetto timeline. Each tile renders as
the fdtrace thread (tid from trace/export.py) and a `<tile>/host`
sampler thread (tid offset by HOST_TID_BASE); a tile whose capture
manifest holds kernel events gets a `<tile>/device` track too (tid
offset by DEVICE_TID_BASE), one slice a kernel.

Folded text is the flamegraph.pl / speedscope interchange format:

    <tile>;<state>;frame;frame;... <count>

one line per (tile, state, stack): two captures diff with `diff` or
flamegraph.pl --negate.
"""
from __future__ import annotations

import json

from .recorder import STATE_NAMES, region_for

HOST_TID_BASE = 1000
DEVICE_TID_BASE = 2000


def read_folded(plan: dict, wksp, tiles=None) -> dict[str, dict]:
    """{tile: {folded_stack: {state: count}}} for every profiled tile
    (or the `tiles` subset) — live or post-mortem."""
    out: dict[str, dict] = {}
    for tn in plan["tiles"]:
        if tiles is not None and tn not in tiles:
            continue
        region = region_for(plan, wksp, tn)
        if region is None:
            continue
        out[tn] = region.folded()
    return out


def folded_text(folded_by_tile: dict[str, dict]) -> str:
    """Folded-stack interchange text, stable-sorted for diffing."""
    lines = []
    for tn in sorted(folded_by_tile):
        for stack, states in sorted(folded_by_tile[tn].items()):
            for st, cnt in sorted(states.items()):
                lines.append(f"{tn};{st};{stack} {cnt}")
    return "\n".join(lines) + ("\n" if lines else "")


def read_samples(plan: dict, wksp,
                 tiles=None) -> dict[str, list[dict]]:
    """{tile: [{ts, state, stack}]} — the timestamped sample streams
    (ring snapshots, oldest-first)."""
    out: dict[str, list[dict]] = {}
    for tn in plan["tiles"]:
        if tiles is not None and tn not in tiles:
            continue
        region = region_for(plan, wksp, tn)
        if region is None:
            continue
        recs = []
        for ts, idx, st in region.snapshot_ring():
            stack = region.stack_at(idx)
            if stack is None:
                continue           # torn/overwritten slot: drop
            recs.append({"ts": ts,
                         "state": STATE_NAMES[st % len(STATE_NAMES)],
                         "stack": stack})
        out[tn] = recs
    return out


def merged_chrome(plan: dict, wksp, tiles=None) -> dict:
    """The merged bundle: fdtrace spans, host sampler slices and the
    device captures' kernels on one timeline (open at ui.perfetto.dev).
    Works with any surface alone: an untraced but profiled topology
    still gets host slices, and the other way round."""
    from ..trace import export as trace_export
    evs = trace_export.read_rings(plan, wksp, tiles=tiles)
    doc = trace_export.to_chrome(evs, plan.get("topology", "fdtpu"))
    te = doc["traceEvents"]
    pid = 1
    samples = read_samples(plan, wksp, tiles=tiles)
    hz_by_tile = {}
    for tn in samples:
        region = region_for(plan, wksp, tn)
        hz_by_tile[tn] = max(1.0, int(region.hdr[5]) / 1000.0)
    for i, tn in enumerate(sorted(samples)):
        if not samples[tn]:
            continue
        tid = HOST_TID_BASE + i
        te.append({"ph": "M", "pid": pid, "tid": tid,
                   "name": "thread_name",
                   "args": {"name": f"{tn}/host"}})
        dur_us = 1e6 / hz_by_tile[tn]
        for s in samples[tn]:
            leaf = s["stack"].rsplit(";", 1)[-1]
            te.append({"ph": "X", "pid": pid, "tid": tid,
                       "cat": "fdprof", "name": leaf,
                       "ts": s["ts"] / 1e3, "dur": dur_us,
                       "args": {"stack": s["stack"],
                                "state": s["state"]}})
    for i, tn in enumerate(sorted(plan["tiles"])):
        if tiles is not None and tn not in tiles:
            continue
        kev = _capture_kernels(plan, tn)
        if not kev:
            continue
        tid = DEVICE_TID_BASE + i
        te.append({"ph": "M", "pid": pid, "tid": tid,
                   "name": "thread_name",
                   "args": {"name": f"{tn}/device"}})
        for name, ts_ns, dur_ns in kev:
            te.append({"ph": "X", "pid": pid, "tid": tid,
                       "cat": "kernel", "name": name,
                       "ts": ts_ns / 1e3, "dur": dur_ns / 1e3})
    doc["otherData"]["prof"] = "fdprof"
    return doc


def _capture_kernels(plan: dict, tile: str) -> list:
    """The kernel events of a tile's last device capture (its manifest's
    `kernel_events`), [] when it has none."""
    from .device import capture_manifest_path
    try:
        with open(capture_manifest_path(plan.get("topology", "?"),
                                        tile)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    return doc.get("kernel_events") or []


def profile_summary(plan: dict, wksp, top_k: int = 5,
                    tiles=None) -> dict:
    """Per-tile profile digest for the bench observatory: sample
    counts, top-k folded stacks (by total count, with state
    breakdown), and the sampler's drop accounting. Cheap, JSON-able —
    this is what lands in the BENCH json as e2e_profile."""
    out: dict = {}
    for tn, folded in read_folded(plan, wksp, tiles=tiles).items():
        region = region_for(plan, wksp, tn)
        ranked = sorted(folded.items(),
                        key=lambda kv: -sum(kv[1].values()))
        out[tn] = {
            "samples": region.samples,
            "dropped": region.dropped,
            "hz": int(region.hdr[5]) / 1000.0,
            "by_state": {
                st: sum(states.get(st, 0) for states in
                        folded.values())
                for st in STATE_NAMES
                if any(st in states for states in folded.values())},
            "top": [{"stack": stack,
                     "count": sum(states.values()),
                     "states": states}
                    for stack, states in ranked[:top_k]],
        }
    return out


def summary_text(plan: dict, wksp, top_k: int = 5) -> str:
    """Human top-k report (the fdprof CLI default)."""
    lines = ["fdprof summary", "=============="]
    prof = profile_summary(plan, wksp, top_k=top_k)
    if not prof:
        return "no profiled tiles (is [prof] enabled?)\n"
    for tn in sorted(prof):
        p = prof[tn]
        states = " ".join(f"{k}={v}" for k, v in p["by_state"].items())
        lines.append("")
        lines.append(f"{tn}: {p['samples']} samples @ {p['hz']:g} Hz"
                     f" ({states})"
                     + (f" dropped={p['dropped']}" if p["dropped"]
                        else ""))
        for t in p["top"]:
            lines.append(f"  {t['count']:>6}  {t['stack']}")
    # device/compile artifacts, if any tile produced them
    from .device import capture_manifest_path, compile_manifest_path
    topo = plan.get("topology", "?")
    for tn in sorted(plan["tiles"]):
        for label, path in (
                ("capture", capture_manifest_path(topo, tn)),
                ("compile", compile_manifest_path(topo, tn))):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            detail = f"ok={doc.get('ok')}" if label == "capture" \
                else f"compiles={doc.get('compiles')}"
            lines.append(f"{tn}: {label} artifact {path} ({detail})")
    return "\n".join(lines) + "\n"
