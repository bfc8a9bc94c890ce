"""fdtrace export: shm rings -> Perfetto/Chrome JSON, text summary,
black-box dumps (copy of the JAX package's trace/export.py; the
black-box file follows the port's shm prefix, `/dev/shm/fdtt_<topology>
.blackbox.<tile>.json`, where the reference writes `fdtpu_`).

The snapshot side of the flight recorder. Everything here is
reader-only over a joined workspace (live tiles keep writing — the
ring's documented tear window applies) or over a dead topology's shm
segment (the workspace outlives tile processes, so a post-mortem drain
sees exactly the final events).

Chrome-trace mapping (the Perfetto-ingestible JSON array format):

    tile            -> one thread (tid = tile index, named via M events)
    span events     -> "X" complete events (ts = end - dur)
    instant events  -> "i" instants
    frag lineage    -> "s"/"f" flow arrows keyed by the frag sig: the
                       publish on the producing tile starts the flow,
                       every later consume/publish of the same sig on
                       ANOTHER tile binds to it — one transaction
                       microbatch reads as an arrow chain
                       synth -> verify -> dedup -> sink
"""
from __future__ import annotations

import json

from ..runtime.tango import TraceRing
from ..utils.tempo import monotonic_ns
from . import events as ev
from .recorder import link_names


def read_rings(plan: dict, wksp, tiles=None) -> dict[str, list[dict]]:
    """{tile: [decoded event dicts, oldest-first]} for every traced
    tile (or the `tiles` subset)."""
    names = link_names(plan)
    out: dict[str, list[dict]] = {}
    for tn, spec in plan["tiles"].items():
        if tiles is not None and tn not in tiles:
            continue
        off = spec.get("trace_off")
        if off is None:
            continue
        ring = TraceRing(wksp, off, int(spec["trace_depth"]))
        cursor, recs = ring.snapshot()
        evs = [ev.decode(r, names) for r in recs]
        # drop never-written slots a torn cursor read could expose
        out[tn] = [e for e in evs if e["etype"] in ev.NAMES]
        if out[tn]:
            out[tn][0].setdefault("_cursor", cursor)
    return out


def to_chrome(events_by_tile: dict[str, list[dict]],
              topology: str = "fdtpu") -> dict:
    """Decoded events -> a Chrome-trace JSON object (Perfetto opens it
    directly: ui.perfetto.dev 'Open trace file')."""
    pid = 1
    trace_events: list[dict] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": f"fdtpu:{topology}"}},
    ]
    tids = {tn: i + 1 for i, tn in enumerate(sorted(events_by_tile))}
    for tn, tid in tids.items():
        trace_events.append({"ph": "M", "pid": pid, "tid": tid,
                             "name": "thread_name",
                             "args": {"name": tn}})
    # frag lineage: the FIRST publisher of a sig starts the flow, every
    # later frag event with the same sig on a different tile binds it
    first_pub: dict[int, tuple] = {}
    for tn, evs in events_by_tile.items():
        for e in evs:
            if e["etype"] == ev.EV_PUBLISH:
                if e["sig"] not in first_pub or \
                        e["ts"] < first_pub[e["sig"]][0]:
                    first_pub[e["sig"]] = (e["ts"], tn)
    for tn, evs in sorted(events_by_tile.items()):
        tid = tids[tn]
        for e in evs:
            ts_us = e["ts"] / 1e3
            frag = e["etype"] in ev.FRAG_EVENTS
            args = {k: v for k, v in (
                ("sig", e["sig"] if frag or e["sig"] else None),
                ("link", e["link"]),
                ("count", e["count"] or None)) if v is not None}
            if e["etype"] == ev.EV_CHAOS:
                args["action"] = ev.CHAOS_ACTION_NAMES.get(
                    e["count"], "?")
            if e["etype"] in ev.SPANS:
                trace_events.append(
                    {"ph": "X", "pid": pid, "tid": tid, "cat": "fdtpu",
                     "name": e["ev"], "ts": (e["ts"] - e["arg"]) / 1e3,
                     "dur": e["arg"] / 1e3, "args": args})
            else:
                trace_events.append(
                    {"ph": "i", "pid": pid, "tid": tid, "cat": "fdtpu",
                     "name": e["ev"], "ts": ts_us, "s": "t",
                     "args": args})
            if e["etype"] in ev.FRAG_EVENTS:
                fp = first_pub.get(e["sig"])
                fid = f"{e['sig']:#x}"
                if fp and fp[1] == tn and e["etype"] == ev.EV_PUBLISH \
                        and e["ts"] == fp[0]:
                    trace_events.append(
                        {"ph": "s", "pid": pid, "tid": tid,
                         "cat": "frag", "name": "frag", "id": fid,
                         "ts": ts_us})
                elif fp and fp[1] != tn:
                    trace_events.append(
                        {"ph": "f", "bp": "e", "pid": pid, "tid": tid,
                         "cat": "frag", "name": "frag", "id": fid,
                         "ts": ts_us})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"topology": topology,
                          "source": "fdtrace"}}


def lineage(events_by_tile: dict[str, list[dict]]) -> dict[int, list]:
    """sig -> [(ts, tile, ev-name, link), ...] time-ordered: one
    frag's journey across every ring it crossed."""
    chains: dict[int, list] = {}
    for tn, evs in events_by_tile.items():
        for e in evs:
            # frag events ALWAYS carry a meaningful sig — 0 is a real
            # value (synth sigs start at 0), not an absence marker
            if e["etype"] in ev.FRAG_EVENTS:
                chains.setdefault(e["sig"], []).append(
                    (e["ts"], tn, e["ev"], e["link"]))
    for c in chains.values():
        c.sort()
    return chains


def summary(events_by_tile: dict[str, list[dict]]) -> str:
    """Text report: per-link publish->consume latency (frag lineage
    deltas) + per-tile wait/backpressure attribution — the 'where did
    the microseconds go' answer counters cannot give."""
    lines = ["fdtrace summary", "==============="]
    # per-link latency: each consume is measured against the MOST
    # RECENT publish in the sig's chain (per-hop delta, not cumulative
    # from the chain's origin — a slow hop must blame itself)
    per_link: dict[str, list[int]] = {}
    for chain in lineage(events_by_tile).values():
        pub_ts = None
        for ts, _tn, name, link in chain:
            if name == "publish":
                pub_ts = ts
            elif name == "consume" and pub_ts is not None and link:
                per_link.setdefault(link, []).append(ts - pub_ts)
    if per_link:
        lines.append("")
        lines.append(f"{'link':<20}{'frags':>8}{'p50_us':>10}"
                     f"{'p99_us':>10}{'max_us':>10}")
        for link, dts in sorted(per_link.items()):
            dts.sort()
            p = lambda q: dts[min(len(dts) - 1,
                                  int(q * len(dts)))] / 1e3
            lines.append(f"{link:<20}{len(dts):>8}{p(0.50):>10.1f}"
                         f"{p(0.99):>10.1f}{dts[-1] / 1e3:>10.1f}")
    # per-tile attribution
    lines.append("")
    lines.append(f"{'tile':<14}{'events':>8}{'wait_ms':>10}"
                 f"{'bp_ms':>8}{'work_ms':>9}{'tpu_ms':>8}  notes")
    for tn, evs in sorted(events_by_tile.items()):
        acc = {k: 0 for k in ("wait", "backpressure", "work", "tpu")}
        notes = []
        for e in evs:
            if e["etype"] == ev.EV_WAIT:
                acc["wait"] += e["arg"]
            elif e["etype"] == ev.EV_BACKPRESSURE:
                acc["backpressure"] += e["arg"]
            elif e["etype"] == ev.EV_WORK:
                acc["work"] += e["arg"]
            elif e["etype"] in (ev.EV_TPU_DISPATCH, ev.EV_TPU_READBACK):
                acc["tpu"] += e["arg"]
            elif e["etype"] == ev.EV_CPU_FALLBACK:
                notes.append("CPU-FALLBACK")
            elif e["etype"] == ev.EV_CHAOS:
                notes.append("chaos:" + ev.CHAOS_ACTION_NAMES.get(
                    e["count"], "?"))
            elif e["etype"] in (ev.EV_WATCHDOG, ev.EV_RESTART,
                                ev.EV_DOWN):
                notes.append(e["ev"])
            elif e["etype"] == ev.EV_SLO:
                notes.append(f"SLO-BREACH#{e['count']}")
        lines.append(
            f"{tn:<14}{len(evs):>8}{acc['wait'] / 1e6:>10.2f}"
            f"{acc['backpressure'] / 1e6:>8.2f}"
            f"{acc['work'] / 1e6:>9.2f}{acc['tpu'] / 1e6:>8.2f}  "
            + " ".join(notes[:6]))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# black-box dumps (supervisor integration)
# ---------------------------------------------------------------------------

def blackbox_path(topology: str, tile: str) -> str:
    return f"/dev/shm/fdtt_{topology}.blackbox.{tile}.json"


def dump_blackbox(plan: dict, wksp, tile: str, reason: str) -> str | None:
    """Snapshot a (dying) tile's ring to a JSON file — the flight
    recorder's raison d'etre: called by the supervisor on a watchdog
    trip or abnormal death, BEFORE the restart wipes the live state.
    The dump carries both the decoded event list and a ready-to-open
    Chrome-trace object. Returns the path (None if the tile is
    untraced)."""
    evs = read_rings(plan, wksp, tiles=[tile]).get(tile)
    if evs is None:
        return None
    path = blackbox_path(plan.get("topology", "?"), tile)
    doc = {
        "topology": plan.get("topology", "?"),
        "tile": tile,
        "reason": reason,
        "dumped_at_ns": monotonic_ns(),
        "events": [{k: v for k, v in e.items()
                    if not k.startswith("_")} for e in evs],
        "chrome": to_chrome({tile: evs}, plan.get("topology", "?")),
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
