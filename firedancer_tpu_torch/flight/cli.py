"""fdflight CLI: query the durable flight-data archive post-mortem (copy
of the JAX package's flight/cli.py; the same output on the same archive,
and a leading `summary` word, which the reference lacks, names the
default command).

    python -m firedancer_tpu_torch.flight [summary] DIR # archive summary
        [--since NS] [--until NS]      time-range slice (monotonic_ns)
        [--kind metric|hist|link|slo|trace|prof|mark]   (repeatable)
        [--ndjson | --csv]             dump the sliced frames
        [--series SOURCE.NAME]         one (tile|link, metric) series
        [--cumulative]                 re-integrate counter deltas
        [--incident [PATH|TS]]         list bundles / pick one
        [--out FILE]                   with --incident: export the
                                       bundle's embedded chrome trace
        diff A_T0:A_T1 B_T0:B_T1       window-summary diff (the fdbench
                                       shape over runtime history)

Unlike fdtrace/fdprof this never attaches shm: the archive directory
IS the data source, so every query works after every tile (recorder
included) is SIGKILLed and the workspace is unlinked — the whole point
of the archive.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .archive import (incident_paths, read_frames, series, cumulative,
                      sources_index, window_summary)
from .codec import KIND_NAMES


def _kind_ids(names) -> set | None:
    if not names:
        return None
    by_name = {v: k for k, v in KIND_NAMES.items()}
    out = set()
    for n in names:
        if n not in by_name:
            raise SystemExit(f"fdflight: unknown kind {n!r} "
                             f"(one of {sorted(by_name)})")
        out.add(by_name[n])
    return out


def _summary(dirname: str, frames, dropped: int) -> str:
    idx = sources_index(frames)
    lines = [f"archive {dirname}"]
    if frames:
        t0, t1 = frames[0]["ts"], frames[-1]["ts"]
        lines.append(f"  {len(frames)} frames over "
                     f"{(t1 - t0) / 1e9:.1f}s "
                     f"[{t0} .. {t1}], {dropped} torn/dropped")
    else:
        lines.append(f"  0 frames, {dropped} torn/dropped")
    nodes = sorted({fr["node"] for fr in frames})
    if nodes:
        lines.append(f"  nodes: {nodes}")
    for kind in sorted(idx):
        pairs = idx[kind]
        sample = ", ".join(f"{s}.{n}" for s, n in sorted(pairs)[:4])
        more = f" (+{len(pairs) - 4} more)" if len(pairs) > 4 else ""
        lines.append(f"  {kind:<7} {len(pairs)} series: {sample}{more}")
    incs = incident_paths(dirname)
    lines.append(f"  incidents: {len(incs)}")
    return "\n".join(lines) + "\n"


def _dump_ndjson(frames, out):
    for fr in frames:
        out.write(json.dumps(fr) + "\n")


def _dump_csv(frames, out):
    out.write("ts_ns,node,kind,source,name,value,aux\n")
    for fr in frames:
        out.write(f"{fr['ts']},{fr['node']},{fr['kind_name']},"
                  f"{fr['source']},{fr['name']},{fr['value']},"
                  f"{fr['aux']}\n")


def _pick_incident(dirname: str, sel: str | None) -> str | None:
    incs = incident_paths(dirname)
    if sel is None or sel == "list":
        return None
    if os.path.exists(sel):
        return sel
    hits = [p for p in incs if sel in os.path.basename(p)]
    if len(hits) != 1:
        raise SystemExit(f"fdflight: incident {sel!r} matches "
                         f"{len(hits)} bundles (have "
                         f"{[os.path.basename(p) for p in incs]})")
    return hits[0]


def _incident_line(path: str) -> str:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"  {os.path.basename(path)}  UNREADABLE ({e})"
    return (f"  {os.path.basename(path)}  target={doc.get('target')!r} "
            f"value={doc.get('value')} "
            f"hop={doc.get('saturating_hop')!r} "
            f"frames={len(doc.get('frames') or [])} "
            f"chrome={'yes' if doc.get('chrome') else 'no'}")


def _diff(dirname: str, wa: str, wb: str, kinds) -> str:
    """window_summary(A) vs window_summary(B), fdbench-diff style:
    per-series rate deltas, worst regressions first."""
    def parse(w):
        try:
            lo, hi = w.split(":", 1)
            return int(lo), int(hi)
        except ValueError:
            raise SystemExit(f"fdflight: bad window {w!r} "
                             "(want T0_NS:T1_NS)")
    (a0, a1), (b0, b1) = parse(wa), parse(wb)
    fa, _ = read_frames(dirname, a0, a1, kinds)
    fb, _ = read_frames(dirname, b0, b1, kinds)
    sa, sb = window_summary(fa), window_summary(fb)
    keys = sorted(set(sa["metrics"]) | set(sb["metrics"]))
    rows = []
    for k in keys:
        ra = (sa["metrics"].get(k) or {}).get("rate", 0.0)
        rb = (sb["metrics"].get(k) or {}).get("rate", 0.0)
        if not ra and not rb:
            continue
        pct = 100.0 * (rb - ra) / ra if ra else float("inf")
        rows.append((pct, k, ra, rb))
    rows.sort(key=lambda r: r[0])
    lines = [f"A [{a0}:{a1}] {sa['wall_s']}s vs "
             f"B [{b0}:{b1}] {sb['wall_s']}s  (rates /s)"]
    for pct, k, ra, rb in rows:
        tag = "+inf%" if pct == float("inf") else f"{pct:+8.1f}%"
        lines.append(f"  {k:<40} {ra:>12.1f} -> {rb:>12.1f}  {tag}")
    if not rows:
        lines.append("  (no overlapping series)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdflight",
        description="query a durable flight-data archive (post-mortem "
                    "safe: reads only the [flight] directory)")
    ap.add_argument("dir", help="archive directory ([flight].dir)")
    ap.add_argument("cmd", nargs="*", default=[],
                    help="optional: diff A_T0:A_T1 B_T0:B_T1")
    ap.add_argument("--since", type=int, default=None,
                    help="slice start (monotonic ns)")
    ap.add_argument("--until", type=int, default=None,
                    help="slice end (monotonic ns)")
    ap.add_argument("--kind", action="append", default=None,
                    help=f"frame kind filter, one of "
                         f"{sorted(KIND_NAMES.values())} (repeatable)")
    ap.add_argument("--ndjson", action="store_true",
                    help="dump sliced frames as NDJSON")
    ap.add_argument("--csv", action="store_true",
                    help="dump sliced frames as CSV")
    ap.add_argument("--series", default=None, metavar="SOURCE.NAME",
                    help="extract one series as '<ts> <value>' lines")
    ap.add_argument("--cumulative", action="store_true",
                    help="with --series: re-integrate counter deltas")
    ap.add_argument("--incident", nargs="?", const="list", default=None,
                    metavar="PATH|SUBSTR",
                    help="list incident bundles, or select one by "
                         "path / name substring")
    ap.add_argument("--out", default=None,
                    help="with --incident: write the bundle's chrome "
                         "trace JSON here (ui.perfetto.dev)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["summary"] and len(argv) > 1:
        argv = argv[1:]
    args = ap.parse_args(argv)

    kinds = _kind_ids(args.kind)

    if args.cmd:
        if args.cmd[0] != "diff" or len(args.cmd) != 3:
            raise SystemExit("fdflight: trailing command must be "
                             "'diff A_T0:A_T1 B_T0:B_T1'")
        sys.stdout.write(_diff(args.dir, args.cmd[1], args.cmd[2],
                               kinds))
        return 0

    if args.incident is not None:
        picked = _pick_incident(args.dir, args.incident)
        if picked is None:
            incs = incident_paths(args.dir)
            print(f"{len(incs)} incident bundle(s) in {args.dir}")
            for p in incs:
                print(_incident_line(p))
            return 0
        with open(picked) as f:
            doc = json.load(f)
        print(_incident_line(picked))
        if args.out:
            chrome = doc.get("chrome")
            if not chrome:
                print("fdflight: bundle has no embedded chrome trace "
                      "(topology untraced at seal time)",
                      file=sys.stderr)
                return 1
            with open(args.out, "w") as f:
                json.dump(chrome, f)
            print(f"wrote {args.out} "
                  f"({len(chrome.get('traceEvents', []))} events) — "
                  f"open at ui.perfetto.dev")
        return 0

    frames, dropped = read_frames(args.dir, args.since, args.until,
                                  kinds)
    if args.series:
        if "." not in args.series:
            raise SystemExit("fdflight: --series wants SOURCE.NAME")
        src, name = args.series.split(".", 1)
        pts = series(frames, src, name)
        if args.cumulative:
            pts = cumulative(pts)
        for ts, v in pts:
            print(f"{ts} {v}")
        return 0
    if args.ndjson:
        _dump_ndjson(frames, sys.stdout)
        return 0
    if args.csv:
        _dump_csv(frames, sys.stdout)
        return 0
    sys.stdout.write(_summary(args.dir, frames, dropped))
    return 0
