"""fdprof CLI: drain/export a topology's profile + trace surfaces.

    python -m firedancer_tpu_torch.prof <topology-name | plan.json>
        [--out bundle.json]       merged Perfetto bundle (fdtrace
                                  spans + host flamegraph slices, one
                                  clock domain — open at ui.perfetto.dev)
        [--folded out.folded]     folded-stack text (flamegraph.pl /
                                  speedscope; diff two runs directly)
        [--format summary|chrome|folded]   (default: summary)
        [--tile NAME ...]         restrict to these tiles
        [--top K]                 summary depth (default 5)
        [--capture TILE]          ring the device-capture doorbell on a
                                  profiled tile and return (the tile
                                  opens the window within a
                                  housekeeping pass; the manifest lands
                                  in /dev/shm)

Attaches like the monitor and fdtrace CLIs: through the plan JSON the
runner drops in /dev/shm, live or post-mortem (the shm regions outlive
the tile processes). Copy of the JAX package's prof/cli.py; the capture
window is a `torch.profiler` one (prof/device.py)."""
from __future__ import annotations

import argparse
import json
import os
import sys


def _attach(target: str):
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
        prog="fdprof",
        description="merged profiler export (host stacks + fdtrace + "
                    "device events, one clock)")
    ap.add_argument("target", help="topology name or plan.json path")
    ap.add_argument("--out", default=None,
                    help="write the merged Perfetto bundle here")
    ap.add_argument("--folded", default=None,
                    help="write folded-stack text here")
    ap.add_argument("--format", choices=("summary", "chrome", "folded"),
                    default="summary")
    ap.add_argument("--tile", action="append", default=None)
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--capture", default=None, metavar="TILE",
                    help="request an on-demand device-trace window")
    args = ap.parse_args(argv)

    from . import export
    from .device import request_capture
    from .export import read_folded

    plan, wksp = _attach(args.target)
    try:
        if args.capture:
            if args.capture not in plan["tiles"]:
                print(f"unknown tile {args.capture!r}", file=sys.stderr)
                return 1
            if not request_capture(plan, wksp, args.capture):
                print(f"tile {args.capture!r} is not profiled "
                      f"(no [prof] region)", file=sys.stderr)
                return 1
            from .device import capture_manifest_path
            print(f"capture requested on {args.capture!r}; manifest: "
                  + capture_manifest_path(plan.get("topology", "?"),
                                          args.capture))
            return 0
        folded = read_folded(plan, wksp, tiles=args.tile)
        if not folded:
            print("no profiled tiles (is [prof] enabled in the "
                  "topology config?)", file=sys.stderr)
            return 1
        if args.folded:
            with open(args.folded, "w") as f:
                f.write(export.folded_text(folded))
            print(f"wrote {args.folded}")
        if args.out:
            doc = export.merged_chrome(plan, wksp, tiles=args.tile)
            with open(args.out, "w") as f:
                json.dump(doc, f)
            print(f"wrote {args.out} ({len(doc['traceEvents'])} "
                  f"events) — open at ui.perfetto.dev")
        if args.format == "summary":
            sys.stdout.write(export.summary_text(plan, wksp,
                                                 top_k=args.top))
        elif args.format == "chrome" and not args.out:
            json.dump(export.merged_chrome(plan, wksp,
                                           tiles=args.tile),
                      sys.stdout)
        elif args.format == "folded" and not args.folded:
            sys.stdout.write(export.folded_text(folded))
        return 0
    finally:
        wksp.close()


if __name__ == "__main__":
    raise SystemExit(main())
