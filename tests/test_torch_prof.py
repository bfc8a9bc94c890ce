"""The port's fdprof (firedancer_tpu_torch/prof/) against the JAX
package's (tests/test_prof.py:28-240): the [prof] schema and per-tile
resolution, the ProfRegion's bytes for one record sequence, the sampler
attributing a stem thread, the exports (folded text, samples, the
summary bench.py's e2e_profile holds, the merged bundle), DeviceCapture
on the CPU (a torch.profiler window with CPU activities writing an ok
manifest), CompileWatch over ops/_build.py's loaded entry points, the
CLI's doorbell, and the breach-triggered capture drill in spawned tile
processes on the CPU."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from firedancer_tpu import prof as rprof
from firedancer_tpu import runtime as jrt
from firedancer_tpu.prof import device as rdevice
from firedancer_tpu_torch import prof as tprof
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco.launch import plan_path
from firedancer_tpu_torch.disco.stem import Stem
from firedancer_tpu_torch.disco.topo import TileCtx
from firedancer_tpu_torch.ops import _build
from firedancer_tpu_torch.prof import cli as tcli
from firedancer_tpu_torch.prof import device as tdevice
from firedancer_tpu_torch.runtime import Workspace
from firedancer_tpu_torch.trace import read_rings, writer_for

PROF_SPECS = [
    None, {}, {"enable": True, "hz": 29, "slots": 64},
    {"enable": 1, "tiles": ["a"], "breach_capture": ("b",)},
    {"capture_ms": 50, "stack_depth": 3, "ring": 16},
    {"slotz": 64}, {"ring": 100}, {"hz": 0}, {"hz": 20000},
    {"stack_depth": 0}, {"capture_ms": -1},
    {"breach_capture": "verify"}, {"tiles": [1]}, [1],
]
TILE_SPECS = [None, {}, {"enable": False}, {"hz": 9, "slots": 32},
              {"tiles": ["x"]}, {"capture_ms": 5.0}, {"ring": 3}]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


def test_schema_constants_match_reference():
    assert tprof.PROF_DEFAULTS == rprof.PROF_DEFAULTS
    assert tprof.TILE_PROF_KEYS == rprof.TILE_PROF_KEYS
    assert tprof.STATE_NAMES == rprof.STATE_NAMES


@pytest.mark.parametrize("spec", PROF_SPECS,
                         ids=[f"s{i}" for i in range(len(PROF_SPECS))])
def test_normalize_prof_matches_reference(spec):
    assert _outcome(tprof.normalize_prof, spec) == \
        _outcome(rprof.normalize_prof, spec)


@pytest.mark.parametrize("spec", TILE_SPECS,
                         ids=[f"t{i}" for i in range(len(TILE_SPECS))])
def test_normalize_tile_prof_matches_reference(spec):
    assert _outcome(tprof.normalize_prof, spec, per_tile=True) == \
        _outcome(rprof.normalize_prof, spec, per_tile=True)


@pytest.mark.parametrize("topo", [
    None, {"enable": True, "hz": 50, "tiles": ["a"]},
    {"enable": True}, {"enable": False, "tiles": ["a"]}])
def test_effective_prof_matches_reference(topo):
    t, r = tprof.normalize_prof(topo), rprof.normalize_prof(topo)
    for tile in ("a", "b"):
        for over in ({}, {"enable": True}, {"enable": False},
                     {"enable": True, "hz": 9, "ring": 64}):
            assert tprof.effective_prof(t, tile, over) == \
                rprof.effective_prof(r, tile, over)


@pytest.mark.parametrize("slots,ring", [(64, 128), (8, 8)])
def test_region_bytes_equal_reference(slots, ring):
    """One record sequence (repeat stacks, table overflow past the probe
    budget, ring wrap, the doorbell) into a port and a reference region
    gives the same bytes, and each reads the other's."""
    tw = Workspace(f"/fdtt_tprofb{os.getpid()}", 1 << 21)
    rw = jrt.Workspace(f"/fdtpu_tprofb{os.getpid()}", 1 << 21)
    try:
        regions = [tprof.ProfRegion.create(tw, slots, ring),
                   rprof.ProfRegion.create(rw, slots, ring)]
        rng = np.random.default_rng(slots)
        stacks = [f"m:main;x:f{i};y:g{i % 3}" for i in range(3 * slots)]
        for k in range(5 * ring):
            st = stacks[int(rng.integers(len(stacks)))]
            state = int(rng.integers(4))
            for r in regions:
                r.record(st, state, 1000 + 7 * k)
        for r in regions:
            r.request_capture()
            r.ack_capture(1)
            r.request_capture()
        n = tprof.ProfRegion.footprint(slots, ring)
        assert n == rprof.ProfRegion.footprint(slots, ring)
        got = bytes(tw.view(regions[0].off, n))
        assert got == bytes(rw.view(regions[1].off, n))
        cross = [tprof.ProfRegion(rw, regions[1].off, slots, ring),
                 rprof.ProfRegion(tw, regions[0].off, slots, ring)]
        assert cross[0].folded() == regions[0].folded() == \
            cross[1].folded()
        assert cross[0].snapshot_ring() == regions[1].snapshot_ring()
        assert regions[0].capture_req == 2 and regions[0].capture_ack == 1
        assert tprof.recorder.stack_hash("a;b") == \
            rprof.recorder.stack_hash("a;b")
    finally:
        tw.close()
        rw.close()
        Workspace.unlink_name(tw.name)
        jrt.Workspace.unlink_name(rw.name)


def _plan(tag, prof, trace=None, **kw):
    topo = (Topology(f"tprof{tag}{os.getpid()}", wksp_size=1 << 22,
                     prof=prof, trace=trace)
            .link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4)
            .tile("b", "sink", ins=["a_b"], **kw))
    return topo.build()


class _BusyTile:
    """A stem callback object that works (a busy loop) in runs of eight
    polls, then waits eight, and housekeeps slowly, so every state gets
    sampled: each spin outlasts the interpreter's 5 ms switch interval,
    so the sampler thread gets the GIL inside it, and a sample carries
    the state the previous poll set (the reference's one-poll lag)."""

    def __init__(self, ctx, seconds):
        self.ctx, self.t_end = ctx, time.perf_counter() + seconds
        self.n = 0

    def poll_once(self):
        self.n += 1
        if time.perf_counter() > self.t_end:
            self.ctx.cnc.state = jrt.CNC_HALT
        if (self.n // 8) % 2:
            time.sleep(0.002)
            return 0
        _spin(0.006)
        return 1

    def housekeeping(self):
        _spin(0.008)


def _spin(sec):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < sec:
        sum(range(100))


def test_stem_runs_the_sampler_and_attributes_its_thread():
    """A profiled tile's stem starts the sampler at RUN over its own
    thread, tells it wait / work / housekeep, and stops it on exit; the
    region holds the stem's frames under each state, and the reference's
    readers decode the same aggregate. An unprofiled tile gets no
    region and starts no sampler."""
    plan = _plan("stem", {"enable": True, "hz": 500, "tiles": ["b"],
                          "stack_depth": 4})
    ctx = TileCtx(plan, "b")
    try:
        assert TileCtx(plan, "a").prof is None
        stem = Stem(ctx, _BusyTile(ctx, 0.8), hk_interval_s=0.02,
                    idle_sleep_s=0)
        threads = threading.active_count()
        stem.run()
        assert stem._sampler is None and threading.active_count() == threads
        region = ctx.prof
        assert region.samples > 20 and region.dropped == 0
        folded = region.folded()
        states = set()
        for st in folded.values():
            states |= set(st)
        assert {"wait", "work", "housekeep"} <= states
        assert any("test_torch_prof:_spin" in k and "stem:run" in k
                   for k in folded), list(folded)
        assert all(len(k.split(";")) <= 5 for k in folded)
        rr = rprof.ProfRegion(ctx.wksp, region.off, region.slots,
                              region.ring)
        assert rr.folded() == folded
        assert int(region.hdr[5]) == 500_000
    finally:
        ctx.close()
        Workspace.unlink_name(plan["wksp"]["name"])


def test_exports_match_reference():
    """read_folded, folded_text, read_samples, profile_summary (the
    e2e_profile block's keys) and the merged bundle over one workspace
    with both a traced and a profiled tile: the port's equal the
    reference's."""
    plan = _plan("exp", {"enable": True, "slots": 64, "ring": 64},
                 trace={"enable": True, "depth": 64})
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    rw = jrt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                       create=False)
    try:
        for k, tn in enumerate(("a", "b")):
            region = tprof.region_for(plan, w, tn)
            region.hdr[5] = 97_000
            for i in range(40 + 10 * k):
                region.record(f"stem:run;{tn}:f{i % 5}", i % 4,
                              10**9 + 1000 * i)
            tr = writer_for(plan, w, tn)
            tr.event(1)
            tr.span(6, 10**9 + 5)
        folded = tprof.read_folded(plan, w)
        assert folded == rprof.read_folded(plan, rw)
        assert tprof.folded_text(folded) == rprof.folded_text(folded)
        assert tprof.read_samples(plan, w) == rprof.read_samples(plan, rw)
        got = tprof.profile_summary(plan, w, top_k=3)
        assert got == rprof.profile_summary(plan, rw, top_k=3)
        assert set(got["b"]) == {"samples", "dropped", "hz", "by_state",
                                 "top"}
        doc = tprof.merged_chrome(plan, w)
        ref = rprof.merged_chrome(plan, rw)
        assert doc["otherData"]["prof"] == "fdprof"
        assert len(doc["traceEvents"]) == len(ref["traceEvents"])
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "thread_name"}
        assert {"a", "b", "a/host", "b/host"} <= names
    finally:
        rw.close()
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])


def test_device_capture_on_the_cpu_writes_an_ok_manifest():
    """The doorbell opens a torch.profiler window with CPU activities in
    one pass, a later pass past capture_ms closes it: the manifest has
    the reference's keys plus the kernel summary (none on the CPU), the
    Chrome trace is written, the tile's ring holds EV_PROF_CAPTURE, the
    ack lands; the halt path's flush closes an open window; a tile
    warmed at boot records the cost."""
    plan = _plan("cap", {"enable": True, "capture_ms": 40.0,
                         "tiles": ["b"]},
                 trace={"enable": True, "depth": 64})
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    path = tdevice.capture_manifest_path(plan["topology"], "b")
    try:
        region = tprof.region_for(plan, w, "b")
        cap = tdevice.DeviceCapture(plan, "b", region,
                                    trace=writer_for(plan, w, "b"),
                                    device="cpu", warm=True)
        assert cap.warm_ms > 0
        assert cap.poll() is None and cap._active is None
        assert tdevice.request_capture(plan, w, "b")
        assert not tdevice.request_capture(plan, w, "a")
        assert cap.poll() is None and cap._active is not None
        x = torch.ones(64, 64)
        while cap.poll() is None:
            x = x @ x / 64
        assert region.capture_ack == 1 and cap.captures == 1
        with open(path) as f:
            doc = json.load(f)
        ref_keys = {"topology", "tile", "req", "t0_ns", "t1_ns",
                    "window_ms", "ok", "trace_dir", "error"}
        assert ref_keys <= set(doc)
        assert doc["ok"] and doc["error"] is None, doc["error"]
        assert doc["req"] == 1 and doc["window_ms"] == 40.0
        assert doc["recorded_ms"] >= 40.0 and doc["kernels"] == {}
        assert doc["device_busy_share"] == 0.0 and doc["warm_ms"] > 0
        assert doc["clock"] == "mark"
        assert os.path.exists(doc["trace_file"])
        evs = read_rings(plan, w, tiles=["b"])["b"]
        assert [e["ev"] for e in evs] == ["prof_capture"]
        region.request_capture()
        cap.poll()
        cap.flush()
        assert region.capture_ack == 2 and cap.captures == 2
    finally:
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])
        if os.path.exists(path):
            os.unlink(path)


def test_read_trace_busy_union_and_clock():
    """Overlapping and clipped kernel intervals: device_busy_ms is their
    union inside the recorded window, kernels sums launches and µs, and
    kernel_events sit on monotonic_ns through the mark."""
    path = f"/tmp/fdtt_trace{os.getpid()}.json"
    evs = [{"ph": "X", "cat": "user_annotation", "name": tdevice.MARK,
            "ts": 100.0, "dur": 1.0},
           {"ph": "X", "cat": "kernel", "name": "k1", "ts": 110.0,
            "dur": 10.0},
           {"ph": "X", "cat": "kernel", "name": "k2", "ts": 115.0,
            "dur": 10.0},
           {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200.0,
            "dur": 50.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 90.0,
            "dur": 500.0}]
    with open(path, "w") as f:
        json.dump({"traceEvents": evs}, f)
    try:
        mark = 5_000_000
        got = tdevice.read_trace(path, mark, mark, mark + 120_000)
        assert got["kernels"] == {"k1": {"launches": 2, "us": 60.0},
                                  "k2": {"launches": 1, "us": 10.0}}
        assert got["device_busy_ms"] == pytest.approx(0.035)
        assert got["device_busy_share"] == pytest.approx(35 / 120)
        assert got["kernel_events"][0] == ["k1", mark + 10_000, 10_000]
        assert got["clock"] == "mark"
        assert tdevice.busy_union_ns([(0, 5), (3, 9), (20, 21)]) == 10
        # no mark, no guessed alignment: the capture records the error
        with open(path, "w") as f:
            json.dump({"traceEvents": evs[1:]}, f)
        with pytest.raises(ValueError, match=tdevice.MARK):
            tdevice.read_trace(path, mark, mark, mark + 120_000)
    finally:
        os.unlink(path)


def test_compile_watch_counts_loaded_entry_points(monkeypatch):
    """kernel_loads() is the size of ops/_build.py's `_libs`; CompileWatch
    sees it grow, stamps EV_COMPILE with the count, and writes the
    reference's manifest keys (cache_miss: loads past `boot`). Fed the
    same counts, the reference's CompileWatch returns the same."""
    plan = _plan("cw", None, trace={"enable": True, "depth": 64})
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    path = tdevice.compile_manifest_path(plan["topology"], "b")
    try:
        libs = {}
        monkeypatch.setattr(_build, "_libs", libs)
        assert tdevice.kernel_loads() == 0
        libs["sha512", "fdtt_sha512_ram"] = object()
        libs["ed25519_verify", "fdtt_ed25519_verify"] = object()
        port = tdevice.CompileWatch(plan, "b", tdevice.kernel_loads,
                                    trace=writer_for(plan, w, "b"),
                                    mem_fn=lambda: 4096, boot=2)
        ref = rdevice.CompileWatch(plan, "b", tdevice.kernel_loads,
                                   manifest=False)
        seq = []
        for step in range(4):
            if step == 2:
                libs["ed25519_msm", "fdtt_msm_stage1"] = object()
            seq.append((port.poll(), ref.poll()))
        assert seq == [(2, 2), (None, None), (3, 3), (None, None)]
        with open(path) as f:
            doc = json.load(f)
        assert doc["compiles"] == 3 and doc["cache_miss"] == 1
        assert doc["device_mem_bytes"] == 4096
        evs = read_rings(plan, w, tiles=["b"])["b"]
        assert [(e["ev"], e["count"], e["arg"]) for e in evs] == \
            [("compile", 2, 4096), ("compile", 3, 4096)]
    finally:
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])
        if os.path.exists(path):
            os.unlink(path)


def test_cli_rings_the_doorbell_and_exports(tmp_path, capsys):
    """`python -m firedancer_tpu_torch.prof NAME --capture TILE` raises
    the tile's capture_req; an unknown or unprofiled tile exits 1; the
    summary, folded and bundle outputs read the same shm."""
    plan = _plan("cli", {"enable": True, "tiles": ["b"]})
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    with open(plan_path(plan["topology"]), "w") as f:
        json.dump(plan, f)
    try:
        region = tprof.region_for(plan, w, "b")
        region.record("stem:run;x:y", 1, 10**9)
        assert tcli.main([plan["topology"], "--capture", "b"]) == 0
        assert region.capture_req == 1
        assert tcli.main([plan["topology"], "--capture", "a"]) == 1
        assert tcli.main([plan["topology"], "--capture", "zz"]) == 1
        out = tmp_path / "p.json"
        folded = tmp_path / "p.folded"
        assert tcli.main([plan_path(plan["topology"]), "--out", str(out),
                          "--folded", str(folded)]) == 0
        assert "b: 1 samples" in capsys.readouterr().out
        assert folded.read_text() == "b;work;stem:run;x:y 1\n"
        assert json.loads(out.read_text())["otherData"]["prof"] == "fdprof"
    finally:
        w.close()
        os.unlink(plan_path(plan["topology"]))
        Workspace.unlink_name(plan["wksp"]["name"])


def test_breach_triggered_capture_drill_on_the_cpu():
    """The reference's drill (tests/test_prof.py:357-420) in spawned
    tile processes with the verify tile on the CPU: an objective that
    cannot hold (verify.work p99 < 1ns) breaches on the metric tile,
    which rings the verify tile's doorbell ([prof] breach_capture); the
    verify tile, its profiler warmed at boot, opens a torch.profiler
    window in a housekeeping pass, closes it in a later one and acks:
    prof_captures 1, an ok manifest, EV_PROF_CAPTURE in its ring (the
    plain versions load no kernel, so EV_COMPILE is the card's check:
    chip_smoke.py phase 21), the breach recovered by the monitor from
    shm, and a merged bundle with host slices of both tiles."""
    from firedancer_tpu_torch.disco import monitor
    topo = (
        Topology(f"tprofdrill{os.getpid()}", wksp_size=1 << 23,
                 trace={"enable": True, "depth": 1024},
                 prof={"enable": True, "hz": 200, "capture_ms": 100.0,
                       "breach_capture": ["verify"]},
                 slo={"fast_window_s": 0.4, "slow_window_s": 30.0,
                      "target": [{"name": "impossible-latency",
                                  "expr": "verify.work p99 < 1ns"}]})
        .link("s_v", depth=64, mtu=1280)
        .link("v_k", depth=64, mtu=1280)
        .tcache("tc", depth=64)
        .tile("synth", "synth", outs=["s_v"], count=16, unique=16,
              seed=3)
        .tile("verify", "verify", ins=["s_v"], outs=["v_k"], batch=16,
              tcache="tc", device="cpu")
        .tile("sink", "sink", ins=["v_k"])
        .tile("metric", "metric", port=0))
    plan = topo.build()
    runner = TopologyRunner(plan).start()
    manifest = tdevice.capture_manifest_path(plan["topology"], "verify")
    try:
        runner.wait_running(timeout_s=240)
        runner.wait_idle("verify", "prof_captures", 1, timeout_s=240)
        m = runner.metrics("metric")
        assert m["slo_breaches"] >= 1 and m["slo_evals"] > 0
        region = tprof.region_for(plan, runner.wksp, "verify")
        assert region.capture_ack >= 1 and region.samples > 0
        with open(manifest) as f:
            doc = json.load(f)
        assert doc["ok"], doc["error"]
        assert doc["device"] == "cpu" and doc["warm_ms"] > 0
        evs = {e["ev"] for e in read_rings(plan, runner.wksp,
                                           tiles=["verify"])["verify"]}
        assert "prof_capture" in evs
        got = monitor.slo_breach_events(plan, runner.wksp)
        assert got and got[0]["target"] == "impossible-latency"
        bundle = tprof.merged_chrome(plan, runner.wksp)
        hosts = {e["args"]["name"] for e in bundle["traceEvents"]
                 if e.get("name") == "thread_name"
                 and e["args"]["name"].endswith("/host")}
        assert {"verify/host", "metric/host"} <= hosts
    finally:
        runner.halt(join_timeout_s=10)
        runner.close()
        for p in (manifest,
                  tdevice.compile_manifest_path(plan["topology"],
                                                "verify")):
            if os.path.exists(p):
                os.unlink(p)
        from firedancer_tpu_torch.disco.slo import slo_dump_path
        p = slo_dump_path(plan["topology"], "impossible-latency")
        if os.path.exists(p):
            os.unlink(p)
