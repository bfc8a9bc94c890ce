"""Repeated runs of the port's main-path topology, with a probe in the
verify tile process: the spread of e2e_tps and verify work across runs
of one call, and what the verify tile's slowest polls hold.

    python -m firedancer_tpu_torch.tools.topo_probe [--runs 3] \\
        [--count 65536] [--device cuda]

Each run boots firedancer_tpu_torch/cfg/sigverify.toml (synth -> verify
-> dedup -> sink, four spawned tile processes, FDTPU_VERIFY_INFLIGHT=3)
as chip_smoke.py's phase 10a does, with the verify tile in one of three
modes, the first two interleaved `--runs` times each, the third once at
the end:

  default  the tile as the launcher runs it;
  freeze   gc.freeze() as the stem starts, after the warmup, so that no
           collection walks the objects of the boot;
  profile  cProfile over the stem's run: the functions the time went to.

In the verify tile the probe times every poll (an idle one may block on
a batch's readback) and every garbage collection (generation, duration,
the poll it fell in). Each run prints one JSON line: e2e_tps, verify
work p50/p99 and tpu p99 from the stem's histograms, the slowest polls
(frames 0: an idle poll) with the collection time inside them, and the
collections of the run by generation. The last line is the card's name
and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

from ..app.config import build_topology, load_config
from ..disco.launch import TopologyRunner
from ..disco.metrics import quantile_ns, read_hists

TOML = os.path.join(os.path.dirname(os.path.dirname(__file__)), "cfg",
                    "sigverify.toml")
SLOW_POLLS = 5            # slowest productive polls reported per run


def _probe(mode: str, path: str):
    """Install the probe in this (verify tile) process; the record is
    written to `path` when the stem's run returns."""
    import gc

    from ..disco import stem, tiles
    st = {"gc_t": 0, "gc_ns": 0, "running": False, "i": 0, "work": 0}
    gcs, polls = [], []

    def on_gc(phase, info):
        now = time.perf_counter_ns()
        if phase == "start":
            st["gc_t"] = now
            return
        dt = now - st["gc_t"]
        st["gc_ns"] += dt
        if st["running"]:
            gcs.append((info["generation"], dt))
    gc.callbacks.append(on_gc)

    poll = tiles.VerifyAdapter.poll_once

    def timed_poll(self):
        # productive polls, and idle ones over 1 ms (an idle poll may
        # block on an in-flight batch's readback)
        g0, t0 = st["gc_ns"], time.perf_counter_ns()
        n = poll(self)
        dt = time.perf_counter_ns() - t0
        st["work"] += bool(n)
        if n or dt > 1_000_000:
            polls.append((dt, n, st["gc_ns"] - g0, st["i"]))
        st["i"] += 1
        return n
    tiles.VerifyAdapter.poll_once = timed_poll

    run = stem.Stem.run

    def probed_run(self, max_iters=None):
        prof = None
        if mode == "freeze":
            gc.freeze()
        elif mode == "profile":
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
        st["running"] = True
        try:
            return run(self, max_iters)
        finally:
            st["running"] = False
            rec = {"polls": st["i"], "productive_polls": st["work"],
                   "slow_polls": [
                       {"index": i, "ms": ns / 1e6, "frames": n,
                        "gc_ms": g / 1e6}
                       for ns, n, g, i in sorted(polls)[-SLOW_POLLS:]],
                   "gc": {str(gen): {
                       "count": sum(1 for g, _ in gcs if g == gen),
                       "ms": sum(d for g, d in gcs if g == gen) / 1e6,
                       "max_ms": max((d for g, d in gcs if g == gen),
                                     default=0) / 1e6}
                          for gen in (0, 1, 2)}}
            if prof is not None:
                import pstats
                prof.disable()
                ps = pstats.Stats(prof)
                top = sorted(ps.stats.items(), key=lambda kv: -kv[1][3])
                rec["profile_cum_ms"] = [
                    [f"{fn[0].rsplit('/', 2)[-1]}:{fn[1]}:{fn[2]}",
                     v[1], v[3] * 1e3] for fn, v in top[:25]]
            with open(path, "w") as f:
                json.dump(rec, f)
    stem.Stem.run = probed_run


def _probe_main(plan: dict, tile_name: str, mode: str, out: str):
    """Tile process entry: launch.tile_main, probed in the verify tile."""
    from ..disco.launch import tile_main
    if plan["tiles"][tile_name]["kind"] == "verify":
        _probe(mode, os.path.join(out, f"{plan['topology']}.json"))
    tile_main(plan, tile_name)


class _ProbeRunner(TopologyRunner):
    """TopologyRunner whose tile processes start in _probe_main."""

    def __init__(self, plan: dict, mode: str, out: str):
        self.mode, self.out = mode, out
        super().__init__(plan)

    def _spawn(self, tn: str, rejoin: bool = False):
        p = self._mp.Process(target=_probe_main,
                             args=(self.plan, tn, self.mode, self.out),
                             name=f"tile:{tn}", daemon=True)
        p.start()
        self.procs[tn] = p
        return p


def run_once(i: int, mode: str, count: int, device: str, out: str) -> dict:
    cfg = load_config(TOML, overrides={
        "tile": [{"name": "synth", "count": count},
                 {"name": "verify", "device": device}]})
    unique = min(count, next(t["unique"] for t in cfg["tile"]
                             if t["name"] == "synth"))
    plan = build_topology(cfg, name=f"probe{i}_{os.getpid()}").build()
    runner = _ProbeRunner(plan, mode, out)
    try:
        t_boot = time.perf_counter()
        runner.start().wait_running(timeout_s=600)
        t0 = time.perf_counter()
        runner.wait_idle("sink", "rx", unique, timeout_s=300, poll_s=0.002)
        runner.wait_idle("verify", "rx", count, timeout_s=300,
                         poll_s=0.002)
        wall = time.perf_counter() - t0
        runner.halt()
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, f"tile {tn} exit code {p.exitcode}"
        v = runner.metrics("verify")
        assert (v["verify_fail"], v["device_errors"]) == (0, 0), v
        vh = read_hists(runner.wksp, plan, "verify")
    finally:
        runner.halt()
        runner.close()
    with open(os.path.join(out, f"{plan['topology']}.json")) as f:
        probe = json.load(f)
    return {"run": i, "mode": mode, "e2e_tps": count / wall,
            "e2e_wall_s": wall, "boot_s": t0 - t_boot,
            "verify_work_p50_ms": quantile_ns(vh["work"], 0.50) / 1e6,
            "verify_work_p99_ms": quantile_ns(vh["work"], 0.99) / 1e6,
            "verify_work_ms": vh["work"]["sum_ns"] / 1e6,
            "tpu_p99_ms": quantile_ns(vh["tpu"], 0.99) / 1e6,
            "tpu_ms": vh["tpu"]["sum_ns"] / 1e6,
            "batches": v["batches"], **probe}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="topo_probe")
    ap.add_argument("--runs", type=int, default=3,
                    help="runs of each of default and freeze")
    ap.add_argument("--count", type=int, default=65536)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.environ["FDTPU_VERIFY_INFLIGHT"] = "3"
    modes = ["default", "freeze"] * args.runs + ["profile"]
    recs = []
    with tempfile.TemporaryDirectory() as out:
        for i, mode in enumerate(modes):
            recs.append(run_once(i, mode, args.count, args.device, out))
            print(json.dumps(recs[-1]), flush=True)
    for mode in ("default", "freeze"):
        tps = sorted(r["e2e_tps"] for r in recs if r["mode"] == mode)
        print(json.dumps({"mode": mode, "e2e_tps_min": tps[0],
                          "e2e_tps_median": statistics.median(tps),
                          "e2e_tps_max": tps[-1]}), flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        smi = ""
    print(smi or "nvidia-smi: not available", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
