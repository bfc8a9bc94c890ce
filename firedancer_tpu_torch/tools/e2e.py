"""The end-to-end run of the port's main path: bench.py's `_e2e_run`
(bench.py:205-330 in the JAX package's checkout) on the port.

    rec = e2e_run(count, unique, batch, coalesce_us, device="cuda")

boots firedancer_tpu_torch/cfg/sigverify.toml (synth -> verify -> dedup
-> sink as four tile processes; bench.py builds the same topology in
code) with the synth's `count` and `unique`, the verify tile's `batch`,
`coalesce_us` and `device`, and FDTPU_VERIFY_INFLIGHT=3, without
FDTPU_TUNED_PROFILE (the point measured is the one asked for). It waits
until every tile runs, then until the sink has the unique frames and verify
has taken all `count`, and every frame is accounted for; then halts the
tiles and reads their flushed telemetry. It raises on a dead tile, a
timeout, a tile that exits non-zero, a verify failure, a parse failure,
a device error or CPU fallback, a strict path that never dispatched, or
a link whose producer and consumer counts differ from the frames that
crossed it. The record holds bench.py's `e2e_tps`, `e2e_count` and
`e2e_wall_s`, the verify tile's work and device-seam quantiles, each
tile's stage budget and each link's budget, and `verify`, the verify
tile's metrics.

The offline sweep (`python -m firedancer_tpu_torch.tune sweep`) measures
each point with it, and chip_smoke.py's topology phases (10a-10c, 18b)
run it on the card. Unlike bench.py's it has no [prof] of its own (the
caller passes one) and writes no flight archive (bench.py's
FDTPU_BENCH_FLIGHT_DIR stage is ROADMAP.md queue A item 1b).
"""
from __future__ import annotations

import os
import time

TOML = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "cfg", "sigverify.toml")


def no_fallback(where: str, m: dict):
    """The gate of every verify tile outside the fault drills: no device
    error and no CPU fallback."""
    assert m["cpu_fallback"] == 0 and m["device_errors"] == 0, \
        f"{where}: cpu_fallback {m['cpu_fallback']}, device_errors " \
        f"{m['device_errors']}"


def e2e_run(count: int, unique: int | None = None, batch: int | None = None,
            coalesce_us: float | None = None, device: str = "cuda", *,
            name: str | None = None, verify_last: bool = False,
            trace: dict | None = None, prof: dict | None = None,
            on_halted=None, **verify) -> dict:
    """One synth -> verify -> dedup -> sink run (see the module doc).
    `unique`, `batch` and `coalesce_us` default to the TOML's;
    `verify` holds further verify args (`mode`, ...). verify_last boots
    the verify tile only once the synth has filled the ingest ring (its
    first gather is full, which opens the bulk prefilter's window).
    `trace` and `prof` are [trace] and [prof] sections to run with;
    `on_halted(runner)` reads the halted topology before its workspace
    goes, and its result joins the record as "trace"."""
    from ..app.config import build_topology, load_config
    from ..disco.launch import TopologyRunner
    from ..disco.metrics import (link_lag, merge_hists, quantile_ns,
                                 read_hists, read_link_metrics)
    synth = {"name": "synth", "count": count}
    if unique is not None:
        synth["unique"] = unique
    vargs = {"name": "verify", "device": device, **verify}
    if batch is not None:
        vargs["batch"] = batch
    if coalesce_us is not None:
        vargs["coalesce_us"] = coalesce_us
    over = {"tile": [synth, vargs]}
    if trace is not None:
        over["trace"] = trace
    if prof is not None:
        over["prof"] = prof
    cfg = load_config(TOML, overrides=over)
    unique = next(t["unique"] for t in cfg["tile"] if t["name"] == "synth")
    env0 = os.environ.get("FDTPU_VERIFY_INFLIGHT")
    os.environ["FDTPU_VERIFY_INFLIGHT"] = "3"
    # the point measured is the one asked for: a tuned profile in the
    # environment would overwrite its verify args at build_topology
    tuned = os.environ.pop("FDTPU_TUNED_PROFILE", None)
    try:
        topo = build_topology(cfg, name=name or f"e2e{os.getpid()}")
    finally:
        if tuned is not None:
            os.environ["FDTPU_TUNED_PROFILE"] = tuned
    runner = TopologyRunner(topo.build())
    try:
        t_boot = time.perf_counter()
        if verify_last:
            runner.start([tn for tn in runner.plan["tiles"]
                          if tn != "verify"])
            runner.wait_idle("synth", "tx", min(
                count, runner.plan["links"]["ingest"]["depth"]),
                timeout_s=300, poll_s=0.002)
            runner.start(["verify"])
        else:
            runner.start()
        runner.wait_running(timeout_s=300)
        t0 = time.perf_counter()
        runner.wait_idle("sink", "rx", unique, timeout_s=300, poll_s=0.002)
        runner.wait_idle("verify", "rx", count, timeout_s=300, poll_s=0.002)
        wall = time.perf_counter() - t0
        deadline = time.time() + 60
        while True:
            runner.check_failures()
            v, d = runner.metrics("verify"), runner.metrics("dedup")
            if d["tx"] + v["dedup_drop"] + d["dup"] == count:
                break
            assert time.time() < deadline, \
                f"frames unaccounted for: verify {v}, dedup {d}"
            time.sleep(0.01)
        snk = runner.metrics("sink")
        for key, got, want in (("sink.rx", snk["rx"], unique),
                               ("verify.rx", v["rx"], count),
                               ("verify.verify_fail", v["verify_fail"], 0),
                               ("verify.parse_fail", v["parse_fail"], 0),
                               ("dedup.tx", d["tx"], unique)):
            assert got == want, f"{key} = {got}, expected {want}"
        no_fallback(f"{runner.plan['topology']} verify", v)
        assert v["batches"] > 0, "no strict dispatch in the verify tile"
        # every stem flushes its histograms and link counters on a clean
        # exit; the workspace stays until close(), so what is read below
        # is what the run did
        runner.halt()
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, f"tile {tn} exit code {p.exitcode}"
        traced = on_halted(runner) if on_halted is not None else None
        budget = {}
        for tn in ("synth", "verify", "dedup", "sink"):
            h = read_hists(runner.wksp, runner.plan, tn)
            work, wait = h["work"], h["wait"]
            busy = work["sum_ns"] + wait["sum_ns"]
            budget[tn] = {
                "work_p50_us": quantile_ns(work, 0.50) / 1e3,
                "work_p99_us": quantile_ns(work, 0.99) / 1e3,
                "occupancy": work["sum_ns"] / busy if busy else 0.0}
        links = {}
        for ln, rec in read_link_metrics(runner.wksp, runner.plan).items():
            cons = rec["consumers"]
            h = merge_hists(c["hist"] for c in cons.values())
            links[ln] = {
                "pub": rec["pub"],
                "consumed": sum(c["consumed"] for c in cons.values()),
                "lost": sum(link_lag(rec, tn) for tn in cons),
                "backpressure": rec["backpressure"],
                "consume_p99_us": quantile_ns(h, 0.99) / 1e3 if h else 0}
        for ln, want in (("ingest", count),
                         ("verify_dedup", count - v["dedup_drop"]),
                         ("dedup_sink", unique)):
            got = (links[ln]["pub"], links[ln]["consumed"],
                   links[ln]["lost"])
            assert got == (want, want, 0), \
                f"link {ln} pub/consumed/lost {got}, expected {want}"
        vh = read_hists(runner.wksp, runner.plan, "verify")
        rec = {
            "e2e_tps": count / wall, "e2e_count": count,
            "e2e_wall_s": wall, "boot_s": t0 - t_boot,
            "verify_work_p50_ms": quantile_ns(vh["work"], 0.50) / 1e6,
            "verify_work_p99_ms": quantile_ns(vh["work"], 0.99) / 1e6,
            "tpu_p50_ms": quantile_ns(vh["tpu"], 0.50) / 1e6,
            "tpu_p99_ms": quantile_ns(vh["tpu"], 0.99) / 1e6,
            "tpu_count": vh["tpu"]["count"],
            # verify's productive polls by log2 bucket upper bound
            "verify_work_polls_by_ms": {
                f"{2 ** (i + 1) / 1e6:g}": c
                for i, c in enumerate(vh["work"]["buckets"]) if c},
            # the device seam's share of the verify tile's productive
            # polls; dispatch and readback may also fall in idle polls
            "device_seam_share": vh["tpu"]["sum_ns"] / vh["work"]["sum_ns"],
            "device_seam_share_of_busy": vh["tpu"]["sum_ns"] / (
                vh["work"]["sum_ns"] + vh["wait"]["sum_ns"]),
            "stage_budget": budget, "link_budget": links,
            "sink_rx": snk["rx"], "verify": v}
        if traced is not None:
            rec["trace"] = traced
        return rec
    finally:
        runner.halt()
        runner.close()
        if env0 is None:
            os.environ.pop("FDTPU_VERIFY_INFLIGHT", None)
        else:
            os.environ["FDTPU_VERIFY_INFLIGHT"] = env0
