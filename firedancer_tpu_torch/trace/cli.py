"""fdtrace CLI: drain/export a topology's flight-recorder rings (copy of
the JAX package's trace/cli.py).

    python -m firedancer_tpu_torch.trace <topology-name | plan.json | blackbox.json>
        [--out trace.json]        write Perfetto/Chrome JSON here
        [--format summary|chrome|both]   (default: summary to stdout)
        [--tile NAME ...]         restrict to these tiles

Attaches exactly like the monitor: via the plan JSON the runner drops
in /dev/shm (`/dev/shm/fdtt_<name>.plan.json`), so it works live
(tiles still writing — snapshot semantics) or POST-MORTEM (the workspace is shm and survives tile
death; drain the rings any time before the runner unlinks). A
black-box dump file written by the supervisor can be re-exported by
passing its path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _attach(target: str):
    """topology name | plan.json path -> (plan, wksp)."""
    from ..disco.launch import plan_path
    from ..runtime import Workspace
    path = target if target.endswith(".json") and os.path.exists(target) \
        else plan_path(target)
    with open(path) as f:
        plan = json.load(f)
    wksp = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                     create=False)
    return plan, wksp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdtrace",
        description="drain/export fdtrace flight-recorder rings")
    ap.add_argument("target",
                    help="topology name, plan.json path, or a "
                         "supervisor blackbox .json dump")
    ap.add_argument("--out", default=None,
                    help="write Chrome-trace/Perfetto JSON to this file")
    ap.add_argument("--format", choices=("summary", "chrome", "both"),
                    default="summary")
    ap.add_argument("--tile", action="append", default=None,
                    help="only these tiles (repeatable)")
    args = ap.parse_args(argv)

    from . import export

    # a blackbox dump re-exports without any live topology
    if args.target.endswith(".json") and os.path.exists(args.target):
        with open(args.target) as f:
            doc = json.load(f)
        if "events" in doc and "tile" in doc:
            evs = {doc["tile"]: doc["events"]}
            if args.format in ("summary", "both"):
                sys.stdout.write(
                    f"blackbox: tile {doc['tile']!r} "
                    f"({doc.get('reason', '?')})\n")
                sys.stdout.write(export.summary(evs))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(export.to_chrome(
                        evs, doc.get("topology", "?")), f)
                print(f"wrote {args.out}")
            elif args.format in ("chrome", "both"):
                json.dump(doc.get("chrome")
                          or export.to_chrome(evs,
                                              doc.get("topology", "?")),
                          sys.stdout)
            return 0

    plan, wksp = _attach(args.target)
    try:
        evs = export.read_rings(plan, wksp, tiles=args.tile)
        if not evs:
            print("no traced tiles (is [trace] enabled in the "
                  "topology config?)", file=sys.stderr)
            return 1
        if args.format in ("summary", "both"):
            sys.stdout.write(export.summary(evs))
        chrome = export.to_chrome(evs, plan.get("topology", "?"))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(chrome, f)
            print(f"wrote {args.out} "
                  f"({len(chrome['traceEvents'])} events) — open at "
                  f"ui.perfetto.dev")
        elif args.format in ("chrome", "both"):
            json.dump(chrome, sys.stdout)
        return 0
    finally:
        wksp.close()
