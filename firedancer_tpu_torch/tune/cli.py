"""fdtune CLI: the operator surface for both tuning layers (copy of the
JAX package's tune/cli.py).

    python -m firedancer_tpu_torch.tune sweep [--out tuned_profile.json]
        [--state PATH]      sweep checkpoint (resume = rerun same path)
        [--count N] [--unique N]   bench point size (e2e frag count)
        [--points N]        candidate values per axis
        [--axes a,b]        knob axes (default coalesce_us,verify_batch)
        [--device cuda|cpu] the verify tile's device (default cuda)
    python -m firedancer_tpu_torch.tune profile show PATH
    python -m firedancer_tpu_torch.tune profile diff A B
    python -m firedancer_tpu_torch.tune watch TARGET
        [--follow] [--interval S]

`sweep` drives tools/e2e.py's e2e_run (the port's copy of bench.py's
e2e harness) — one topology boot per config point — and is killable at
any time: every measured point is already in the --state checkpoint, so
rerunning the same command resumes where it died. Each measured point
logs its record's exact checks to stderr as one `fdtune: e2e {json}`
line (the port's own, beside the reference's log). `watch` tails live
controller decisions (EV_TUNE) from a running topology's trace rings
(TARGET = topology name or plan.json) or, post-mortem, from a flight
archive directory (TARGET = dir).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import RUNTIME_KNOBS, knob_space
from .profile import (diff_profiles, load_profile, make_profile,
                      save_profile)
from .search import DEFAULT_AXES, run_sweep


def _cmd_sweep(args) -> int:
    # tools/e2e.py's e2e_run is THE measurement: the port's copy of
    # bench.py's _e2e_run, which raises on any failed exact check
    from ..tools.e2e import e2e_run
    space = knob_space(None)
    axes = tuple(a.strip() for a in args.axes.split(",") if a.strip())

    def measure(pt: dict) -> float:
        rec = e2e_run(
            args.count, args.unique,
            batch=int(pt.get("verify_batch",
                             space["verify_batch"]["default"])),
            coalesce_us=float(pt.get("coalesce_us",
                                     space["coalesce_us"]["default"])),
            device=args.device)
        v = rec["verify"]
        print("fdtune: e2e " + json.dumps({
            "point": pt, "e2e_tps": rec["e2e_tps"],
            "boot_s": rec["boot_s"], "sink_rx": rec["sink_rx"],
            "unique": args.unique, **{k: v[k] for k in (
                "rx", "batches", "verify_fail", "parse_fail",
                "cpu_fallback", "device_errors")}}, sort_keys=True),
            file=sys.stderr, flush=True)
        return rec["e2e_tps"]

    res = run_sweep(measure, args.state, axes=axes, points=args.points,
                    log=lambda m: print(f"fdtune: {m}", file=sys.stderr))
    doc = make_profile(res["knobs"], res["tuned_tps"],
                       res["default_tps"],
                       sweep={"axes": list(axes), "count": args.count,
                              "unique": args.unique,
                              "points": res["points"],
                              "measured": res["measured"]})
    save_profile(doc, args.out)
    print(f"fdtune: profile -> {args.out} "
          f"(tuned_vs_default_tps "
          f"{res['tuned_vs_default_tps']:.3f}, "
          f"{res['measured']} measured / {res['points']} total points)",
          file=sys.stderr)
    json.dump(doc, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


def _show(doc: dict) -> str:
    m = doc["measured"]
    lines = [
        f"fdtune profile v{doc['fdtune_profile']} "
        f"({doc.get('created_at', '?')})",
        f"  host: {doc['host'].get('hostname', '?')} "
        f"{doc['host'].get('machine', '?')} "
        f"backend={doc['host'].get('backend')}"
        f" x{doc['host'].get('devices', 0)}",
        f"  knee: tuned {m['tuned_tps']:.0f} tps vs default "
        f"{m['default_tps']:.0f} tps "
        f"({m['tuned_vs_default_tps']:.3f}x)",
        "  knobs:",
    ]
    space = knob_space(None)
    for k in sorted(doc["knobs"]):
        v = doc["knobs"][k]
        d = space.get(k, {}).get("default")
        mark = "" if v == d else f"   (default {d})"
        lines.append(f"    {k:<16} = {v}{mark}")
    if doc.get("sweep"):
        lines.append(f"  sweep: {json.dumps(doc['sweep'], sort_keys=True)}")
    return "\n".join(lines)


def _cmd_profile(args) -> int:
    if args.action == "show":
        print(_show(load_profile(args.path)))
        return 0
    # diff
    a, b = load_profile(args.path), load_profile(args.other)
    delta = diff_profiles(a, b)
    if not delta:
        print("profiles agree on every knob")
        return 0
    for k, (av, bv) in sorted(delta.items()):
        print(f"{k:<16} {av} -> {bv}")
    return 1


def _watch_archive(dirname: str) -> int:
    from ..flight.archive import read_frames
    from ..flight.codec import KIND_TRACE
    frames, _ = read_frames(dirname)
    n = 0
    for fr in frames:
        if fr["kind"] != KIND_TRACE or fr["name"] != "tune":
            continue
        idx = fr["aux"] >> 16
        knob = RUNTIME_KNOBS[idx] if idx < len(RUNTIME_KNOBS) \
            else f"knob[{idx}]"
        print(f"{fr['ts']} {fr['source']}: {knob} -> {fr['value']}")
        n += 1
    print(f"fdtune: {n} decisions in archive {dirname}",
          file=sys.stderr)
    return 0


def _watch_rings(target: str, follow: bool, interval: float) -> int:
    from ..disco.launch import plan_path
    from ..runtime import Workspace
    from ..trace import export
    from ..trace.events import EV_TUNE
    path = target if target.endswith(".json") and os.path.exists(target) \
        else plan_path(target)
    with open(path) as f:
        plan = json.load(f)
    wksp = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                     create=False)
    names = plan.get("tune_knobs") or list(RUNTIME_KNOBS)
    seen: set[tuple] = set()
    try:
        while True:
            evs = export.read_rings(plan, wksp)
            for tn in sorted(evs):
                for e in evs[tn]:
                    if e["etype"] != EV_TUNE:
                        continue
                    key = (tn, e["ts"], e["count"], e["arg"])
                    if key in seen:
                        continue
                    seen.add(key)
                    knob = names[e["count"]] \
                        if e["count"] < len(names) \
                        else f"knob[{e['count']}]"
                    hop = f"  [{e['link']}]" if e["link"] else ""
                    print(f"{e['ts']} {tn}: {knob} -> {e['arg']}{hop}",
                          flush=True)
            if not follow:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        wksp.close()
    return 0


def _cmd_watch(args) -> int:
    if os.path.isdir(args.target):
        return _watch_archive(args.target)
    return _watch_rings(args.target, args.follow, args.interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdtune",
        description="offline knob autotuning + controller inspection")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="run the offline knob sweep")
    sw.add_argument("--out", default="tuned_profile.json")
    sw.add_argument("--state", default="fdtune_sweep_state.json",
                    help="checkpoint path; rerun same path to resume")
    sw.add_argument("--count", type=int,
                    default=int(os.environ.get(
                        "FDTPU_TUNE_SWEEP_COUNT", "16384")))
    sw.add_argument("--unique", type=int,
                    default=int(os.environ.get(
                        "FDTPU_TUNE_SWEEP_UNIQUE", "256")))
    sw.add_argument("--points", type=int, default=5,
                    help="candidate values per knob axis")
    sw.add_argument("--axes", default=",".join(DEFAULT_AXES))
    sw.add_argument("--device", default="cuda",
                    help="the verify tile's device (cuda or cpu)")
    sw.set_defaults(fn=_cmd_sweep)

    pr = sub.add_parser("profile", help="inspect tuned profiles")
    pr.add_argument("action", choices=("show", "diff"))
    pr.add_argument("path")
    pr.add_argument("other", nargs="?",
                    help="second profile (diff only)")
    pr.set_defaults(fn=_cmd_profile)

    wa = sub.add_parser(
        "watch", help="tail controller decisions (EV_TUNE)")
    wa.add_argument("target",
                    help="topology name, plan.json, or a flight "
                         "archive directory")
    wa.add_argument("--follow", "-f", action="store_true",
                    help="keep polling the live trace rings")
    wa.add_argument("--interval", type=float, default=1.0)
    wa.set_defaults(fn=_cmd_watch)

    args = ap.parse_args(argv)
    if args.cmd == "profile" and args.action == "diff" \
            and not args.other:
        ap.error("profile diff needs two paths")
    return args.fn(args)
