"""Monitor: read every tile's heartbeat + metrics from shared memory
(copy of the JAX package's disco/monitor.py, with each traced tile's
trace cursor, the SLO breach events and the flight archive's replay).

Usage:
  python -m firedancer_tpu_torch.disco.monitor --archive DIR \
      [--since NS] [--follow]

--archive replays NDJSON snapshots from a flight-data archive
([flight].dir) instead of shm — the view post-mortem: one document per
recorder drain pass, counters re-integrated from the archived deltas.
--since skips documents at or before that monotonic-ns stamp; --follow
keeps polling the directory for frames the recorder is still appending.
The live view is `app.run`'s table (or `attach` and `snapshot` from
code); the reference's live command line is left out.

The reference's `monitor` command attaches to the running validator's
shm and prints per-tile status snapshots
(ref: src/app/shared/commands/monitor/monitor.c:61,100,296-338).
`attach` joins a running topology through the plan JSON the runner
drops next to the shm segment.
"""
from __future__ import annotations

import json
import sys
import time

from ..runtime import (Workspace, Cnc, TraceRing, CNC_BOOT, CNC_RUN,
                       CNC_HALT, CNC_FAIL)
from . import topo as topo_mod
from ..trace import events as trace_ev
from ..trace.export import read_rings
from .launch import plan_path
from .metrics import link_lag, quantile_ns, read_hists, read_link_metrics
from .slo import slo_dump_path
from .supervise import sup_counters

_STATE = {CNC_BOOT: "boot", CNC_RUN: "run", CNC_HALT: "halt",
          CNC_FAIL: "FAIL"}


def snapshot(plan: dict, wksp: Workspace) -> dict:
    """{tile: {kind, state, hb_age_ticks, trace, metrics{...},
    latency{...}}}; trace is None on an untraced tile, else the events
    ever written and the ring's depth (the ring keeps the last depth;
    `python -m firedancer_tpu_torch.trace` drains it)."""
    out = {}
    now = topo_mod.now_ticks()
    for tn, spec in plan["tiles"].items():
        cnc = Cnc(wksp, off=spec["cnc_off"])
        vals = topo_mod.read_metrics(wksp, plan, tn)
        names = spec["metrics_names"]
        hists = read_hists(wksp, plan, tn)
        trace = None
        if spec.get("trace_off") is not None:
            trace = {"events": TraceRing(
                wksp, spec["trace_off"], spec["trace_depth"]).cursor,
                "depth": spec["trace_depth"]}
        out[tn] = {
            "kind": spec["kind"],
            "state": _STATE.get(cnc.state, f"?{cnc.state}"),
            # clamp: clock reads race across processes by a few ticks
            "hb_age_ticks": max(0, now - cnc.last_heartbeat),
            "trace": trace,
            "metrics": {
                **{nm: int(vals[i]) for i, nm in enumerate(names)},
                **sup_counters(vals)},
            "latency": {
                kind: {"count": h["count"],
                       "p50_us": quantile_ns(h, 0.50) / 1e3,
                       "p99_us": quantile_ns(h, 0.99) / 1e3}
                for kind, h in hists.items() if h["count"]
            },
        }
    return out


def links_table(link_metrics: dict) -> dict:
    """read_link_metrics output -> one JSON-able row per (link,
    consumer): publish/consume counters, per-hop loss, backpressure and
    consume-latency quantiles."""
    rows: dict = {}
    for ln, rec in link_metrics.items():
        consumers = {}
        for tn, c in rec["consumers"].items():
            h = c["hist"]
            consumers[tn] = {
                "consumed": c["consumed"],
                "bytes": c["bytes"],
                "overruns": c["overruns"],
                "lag": link_lag(rec, tn),
                "p50_us": quantile_ns(h, 0.50) / 1e3,
                "p99_us": quantile_ns(h, 0.99) / 1e3,
            }
        rows[ln] = {
            "producer": rec["producer"],
            "pub": rec["pub"],
            "pub_bytes": rec["pub_bytes"],
            "backpressure": rec["backpressure"],
            "consumers": consumers,
        }
    return rows


def full_snapshot(plan: dict, wksp: Workspace) -> dict:
    """Tiles, per-link telemetry and the recent SLO breaches in one
    JSON-able document."""
    return {
        "topology": plan.get("topology", "?"),
        "tiles": snapshot(plan, wksp),
        "links": links_table(read_link_metrics(wksp, plan)),
        "slo_events": slo_breach_events(plan, wksp),
    }


def slo_breach_events(plan: dict, wksp: Workspace,
                      limit: int = 8) -> list[dict]:
    """Recent SLO breaches recovered from shm alone: the EV_SLO records
    in the metric tile's flight-recorder ring, plus the engine's
    per-target dumps (/dev/shm/fdtt_<topo>.slo.<target>.json) for
    breaches the wrapping ring has overwritten, so the monitor shows a
    flapping objective without the metric tile's HTTP surface, and
    post-mortem."""
    targets = [t["name"] for t in (plan.get("slo") or {})
               .get("target", [])]
    out: list[dict] = []
    metric_tiles = [tn for tn, spec in plan["tiles"].items()
                    if spec["kind"] == "metric"
                    and spec.get("trace_off") is not None]
    for tn, evs in read_rings(plan, wksp, tiles=metric_tiles).items():
        for e in evs:
            if e["etype"] != trace_ev.EV_SLO:
                continue
            idx = e["count"]
            out.append({"ts": e["ts"],
                        "target": targets[idx]
                        if idx < len(targets) else f"?{idx}",
                        "value": e["arg"]})
    seen = {r["target"] for r in out}
    for name in targets:
        if name in seen:
            continue
        try:
            with open(slo_dump_path(plan.get("topology", "?"),
                                    name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        out.append({"ts": doc.get("dumped_at_ns", 0), "target": name,
                    "value": doc.get("value"),
                    "breaches": doc.get("breaches")})
    out.sort(key=lambda r: r["ts"])
    return out[-limit:]


def format_slo_events(events: list[dict]) -> str:
    if not events:
        return ""
    lines = ["recent SLO breaches (newest last):"]
    for e in events:
        lines.append(f"  ts={e['ts']} {e['target']} value={e['value']}")
    return "\n".join(lines)


def _delta_str(v: int, prev: int | None) -> str:
    if prev is None or v == prev:
        return str(v)
    return f"{v}(+{v - prev})" if v > prev else f"{v}({v - prev})"


def format_table(snap: dict, prev: dict | None = None) -> str:
    lines = [f"{'tile':<14}{'kind':<10}{'state':<7}{'hb_age':>12}"
             f"{'work_p99us':>12}  metrics"]
    for tn, row in snap.items():
        pm = (prev or {}).get(tn, {}).get("metrics", {})
        ms = " ".join(f"{k}={_delta_str(v, pm.get(k))}"
                      for k, v in row["metrics"].items() if v)
        work = row.get("latency", {}).get("work", {})
        p99 = f"{work.get('p99_us', 0):.0f}" if work.get("count") else "-"
        lines.append(f"{tn:<14}{row['kind']:<10}{row['state']:<7}"
                     f"{row['hb_age_ticks']:>12}{p99:>12}  {ms}")
    return "\n".join(lines)


def format_links(links: dict) -> str:
    """Per-link table: one row per (link, consumer) with publish /
    consume / loss / backpressure and the consume-latency quantiles."""
    if not links:
        return ""
    lines = [f"{'link':<18}{'producer':<12}{'consumer':<12}"
             f"{'pub':>10}{'consumed':>10}{'lost':>7}{'bp':>8}"
             f"{'p50us':>8}{'p99us':>8}"]
    for ln in sorted(links):
        rec = links[ln]
        cons = rec["consumers"] or {"-": None}
        for tn in sorted(cons):
            c = cons[tn]
            if c is None:
                lines.append(
                    f"{ln:<18}{rec['producer'] or '-':<12}{'-':<12}"
                    f"{rec['pub']:>10}{'-':>10}{'-':>7}"
                    f"{rec['backpressure']:>8}{'-':>8}{'-':>8}")
                continue
            lines.append(
                f"{ln:<18}{rec['producer'] or '-':<12}{tn:<12}"
                f"{rec['pub']:>10}{c['consumed']:>10}{c['lag']:>7}"
                f"{rec['backpressure']:>8}{c['p50_us']:>8.0f}"
                f"{c['p99_us']:>8.0f}")
    return "\n".join(lines)


def attach(topology_name: str):
    """-> (plan, workspace joined) of a running topology."""
    with open(plan_path(topology_name)) as f:
        plan = json.load(f)
    wksp = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                     create=False)
    return plan, wksp


def archive_snapshots(dirname: str,
                      since_ns: int | None = None) -> list[dict]:
    """Flight-archive frames -> one snapshot document per recorder
    drain pass (every metric/link frame of a pass shares the pass
    timestamp). Counters re-integrate from the archived deltas, so a
    document's values equal what /metrics showed at that instant —
    the fdflight query-equivalence contract applied to the monitor's
    --json shape. `since_ns` drops documents stamped at or before it
    (the --since/--follow replay cursor)."""
    from ..flight.archive import read_frames
    from ..flight.codec import KIND_HIST, KIND_LINK, KIND_METRIC
    frames, _ = read_frames(dirname)
    tiles: dict = {}
    links: dict = {}
    docs: list[dict] = []
    cur_ts = None

    def emit(ts):
        if since_ns is not None and ts <= since_ns:
            return
        docs.append({
            "ts": ts, "source": "flight",
            "tiles": {tn: dict(ms) for tn, ms in tiles.items()},
            "links": {ln: dict(ms) for ln, ms in links.items()},
        })

    for fr in frames:
        if fr["kind"] not in (KIND_METRIC, KIND_HIST, KIND_LINK):
            continue
        if cur_ts is None:
            cur_ts = fr["ts"]
        elif fr["ts"] != cur_ts:
            emit(cur_ts)
            cur_ts = fr["ts"]
        tgt = links if fr["kind"] == KIND_LINK else tiles
        rec = tgt.setdefault(fr["source"], {})
        if fr["aux"] & 1:
            rec[fr["name"]] = fr["value"]     # gauge/level
        else:
            rec[fr["name"]] = rec.get(fr["name"], 0) + fr["value"]
    if cur_ts is not None:
        emit(cur_ts)
    return docs


def _archive_main(dirname: str, since_ns: int | None,
                  follow: bool) -> int:
    cursor = since_ns
    while True:
        docs = archive_snapshots(dirname, since_ns=cursor)
        for doc in docs:
            print(json.dumps(doc))
            cursor = doc["ts"]
        if not follow:
            return 0
        sys.stdout.flush()
        time.sleep(1.0)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if "--archive" not in argv:
        print(__doc__)
        return 1
    dirname = argv[argv.index("--archive") + 1]
    since = int(argv[argv.index("--since") + 1]) \
        if "--since" in argv else None
    return _archive_main(dirname, since, "--follow" in argv)


if __name__ == "__main__":
    raise SystemExit(main())
