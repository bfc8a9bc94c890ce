"""The port's flight recorder (firedancer_tpu_torch.trace, runtime.TraceRing)
against the JAX package's: the ring's raw u64 words after the same appends
(through a wrap), the writer's sampling, the [trace] schema, the exports on
the same decoded events, the chaos action ids, the disabled path (no ring,
`Stem._trace is None`), and a traced four-process pipeline synth -> verify
(device="cpu") -> dedup -> sink whose rings show each unique frame's
lineage verify -> dedup -> sink, exported by `python -m
firedancer_tpu_torch.trace` live and after the halt. Exact: words, dicts
and JSON documents are compared for equality."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu import trace as jtrace
from firedancer_tpu.trace import recorder as jrec
from firedancer_tpu.utils import chaos as jchaos
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch import trace as ttrace
from firedancer_tpu_torch.trace import events as tev
from firedancer_tpu_torch.trace import recorder as trec
from firedancer_tpu_torch.utils import chaos as tchaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "sigverify.toml")

pytestmark = pytest.mark.trace


@pytest.fixture(scope="module")
def wksps():
    ws = (jrt.Workspace(f"/fdtpu_ttr_{os.getpid()}", 1 << 22),
          trt.Workspace(f"/fdtt_ttr_{os.getpid()}", 1 << 22))
    yield ws
    for w in ws:
        w.close()
        w.unlink()


def _words(ring) -> np.ndarray:
    return np.array(ring._v, copy=True)


# -- the ring and the writer ------------------------------------------------

@pytest.mark.parametrize("depth", [8, 64])
def test_ring_words_equal_reference_through_a_wrap(wksps, depth):
    rings = [rt.TraceRing.create(w, depth) for rt, w in zip((jrt, trt),
                                                            wksps)]
    for r in rings:
        for i in range(11):
            r.append(1000 + i, tev.EV_CONSUME, sig=i * 0x1_0000_0001,
                     arg=7 * i, link=i % 3, count=i)
        r.append(2000, tev.EV_WORK, arg=(1 << 64) + 5, count=(1 << 33) + 2)
        r.append_batch(3000, tev.EV_PUBLISH, list(range(100, 120)), link=1)
        r.append_batch(3001, tev.EV_PUBLISH, [])
        r.append(4000, tev.EV_HALT, link=0xFFFF)
    want, got = (_words(r) for r in rings)
    assert np.array_equal(got, want)
    assert int(got[0]) == 33 and int(got[1]) == depth
    cur = [r.snapshot() for r in rings]
    assert cur[0][0] == cur[1][0] and np.array_equal(cur[0][1], cur[1][1])
    names = ["a", "b", "c"]
    assert [tev.decode(x, names) for x in cur[1][1]] == \
        [jtrace.events.decode(x, names) for x in cur[0][1]]
    with pytest.raises(ValueError, match="power of two"):
        trt.TraceRing.create(wksps[1], 100)


@pytest.mark.parametrize("sample", [1, 3, 4])
def test_writer_sampling_words_equal_reference(wksps, monkeypatch, sample):
    """frag_batch (one frag at a time, then batches), event and span
    through both writers, on one deterministic clock: the same records
    land."""
    for mod in (jrec, trec):
        clock = iter(range(10_000, 20_000, 10))
        monkeypatch.setattr(mod, "monotonic_ns", lambda c=clock: next(c))
    rings = []
    for rt, mod, w in ((jrt, jrec, wksps[0]), (trt, trec, wksps[1])):
        r = rt.TraceRing.create(w, 64)
        tw = mod.TraceWriter(r, sample=sample, links={"x": 0, "y": 1})
        for s in range(7):
            tw.frag_batch(tev.EV_CONSUME, np.array([s], np.uint64),
                          link=tw.link_id("x"))
        for lo, hi in ((7, 12), (12, 12), (12, 21)):
            tw.frag_batch(tev.EV_PUBLISH, np.arange(lo, hi, dtype=np.uint64),
                          link=tw.link_id("y"))
        tw.event(tev.EV_BOOT)
        tw.span(tev.EV_TPU_DISPATCH, 10_005, count=32)
        tw.event(tev.EV_CPU_FALLBACK, link=tw.link_id("nosuch"))
        mod.chaos_event(tw, "fail_dispatch", at=3)
        mod.chaos_event(None, "crash")
        rings.append(r)
    assert np.array_equal(_words(rings[1]), _words(rings[0]))
    assert rings[1].cursor == 21 // sample + 4


@pytest.mark.parametrize("sample", [1, 3])
def test_frag_batch_stamps_a_given_time(wksps, sample):
    """A publisher passes the time taken before its frags became visible:
    the records carry it, sampled as they are without it."""
    r = trt.TraceRing.create(wksps[1], 64)
    tw = trec.TraceWriter(r, sample=sample)
    tw.frag_batch(tev.EV_PUBLISH, np.arange(7, dtype=np.uint64), link=2,
                  ts_ns=1234)
    recs = [tev.decode(x, ["a", "b", "c"]) for x in r.snapshot()[1]]
    assert [e["sig"] for e in recs] == list(range(sample - 1, 7, sample))
    assert {e["ts"] for e in recs} == {1234}
    assert {(e["ev"], e["link"]) for e in recs} == {("publish", "c")}


def test_shared_clock_is_the_heartbeat_clock():
    from firedancer_tpu_torch.disco import topo as ttopo
    from firedancer_tpu_torch.runtime.tango import lib
    from firedancer_tpu_torch.utils.tempo import monotonic_ns
    a = lib.fdtpu_ticks()
    b = monotonic_ns()
    c = lib.fdtpu_ticks()
    assert a <= b <= c
    assert abs(ttopo.now_ticks() - monotonic_ns()) < 1e9
    # the stem stamps wait-end records with perf_counter_ns
    assert abs(time.perf_counter_ns() - monotonic_ns()) < 1e9


# -- the schema -------------------------------------------------------------

SPECS = [None, {}, {"enable": True}, {"enable": 1, "depth": 64, "sample": 8,
                                      "tiles": ["a"]},
         {"depth": 100}, {"depth": 0}, {"sample": 0}, {"dept": 64},
         {"tiles": "verify"}, {"tiles": ["a", 3]}, [1, 2], "x",
         {"enable": None}]
TILE_SPECS = [None, {}, {"enable": False}, {"depth": 8, "sample": 2},
              {"tiles": ["a"]}, {"depht": 8}, {"sample": -1}]


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_normalize_trace_matches_reference(spec):
    assert _outcome(trec.normalize_trace, spec) == \
        _outcome(jrec.normalize_trace, spec)


@pytest.mark.parametrize("spec", TILE_SPECS, ids=repr)
def test_normalize_tile_trace_matches_reference(spec):
    assert _outcome(trec.normalize_trace, spec, per_tile=True) == \
        _outcome(jrec.normalize_trace, spec, per_tile=True)


@pytest.mark.parametrize("topo_spec", [
    {"enable": True, "depth": 256, "tiles": ["a"]}, {"enable": True},
    {"enable": False, "sample": 4}])
def test_effective_trace_matches_reference(topo_spec):
    for tile in ("a", "b"):
        for over in ({}, {"enable": False}, {"enable": True},
                     {"enable": True, "depth": 64, "sample": 4},
                     {"sample": 2}):
            want = jrec.effective_trace(jrec.normalize_trace(topo_spec),
                                        tile, over)
            got = trec.effective_trace(trec.normalize_trace(topo_spec),
                                       tile, over)
            assert got == want


def test_event_vocabulary_and_chaos_ids_match_reference():
    for name in ("NAMES", "SPANS", "FRAG_EVENTS", "CHAOS_ACTION_IDS",
                 "CHAOS_ACTION_NAMES"):
        assert getattr(tev, name) == getattr(jtrace.events, name)
    assert set(tev.CHAOS_ACTION_IDS) == set(tchaos.ACTIONS)
    assert tchaos.ACTIONS == jchaos.ACTIONS
    assert all(tev.CHAOS_ACTION_NAMES[i] == a
               for a, i in tev.CHAOS_ACTION_IDS.items())
    assert (trec.TRACE_DEFAULTS, trec.TILE_TRACE_KEYS) == \
        (jrec.TRACE_DEFAULTS, jrec.TILE_TRACE_KEYS)


# -- the exports ------------------------------------------------------------

def _fe(ts, etype, sig=0, link=None, arg=0, count=0):
    return {"ts": ts, "ev": tev.NAMES[etype], "etype": etype, "sig": sig,
            "arg": arg, "link": link, "count": count}


def _events():
    """Three tiles' decoded events: a lineage across two hops with sig 0
    and a sig seen twice, spans of every kind, the instants the summary
    annotates."""
    return {
        "verify": [_fe(90_000, tev.EV_CONSUME, 0, "in_v"),
                   _fe(100_000, tev.EV_PUBLISH, 0, "v_d"),
                   _fe(101_000, tev.EV_PUBLISH, 7, "v_d"),
                   _fe(99_000, tev.EV_TPU_DISPATCH, arg=4_000, count=32),
                   _fe(99_500, tev.EV_TPU_READBACK, arg=400, count=1),
                   _fe(98_000, tev.EV_WORK, arg=9_000, count=12),
                   _fe(70_000, tev.EV_WAIT, arg=20_000),
                   _fe(102_000, tev.EV_CPU_FALLBACK),
                   _fe(103_000, tev.EV_CHAOS, arg=3, count=5),
                   _fe(104_000, tev.EV_BACKPRESSURE, "v_d", arg=1_500)],
        "dedup": [_fe(150_000, tev.EV_CONSUME, 0, "v_d"),
                  _fe(151_000, tev.EV_CONSUME, 7, "v_d"),
                  _fe(160_000, tev.EV_PUBLISH, 0, "d_s"),
                  _fe(170_000, tev.EV_HOUSEKEEP, arg=2_000)],
        "sink": [_fe(200_000, tev.EV_CONSUME, 0, "d_s"),
                 _fe(201_000, tev.EV_DOWN), _fe(202_000, tev.EV_WATCHDOG),
                 _fe(203_000, tev.EV_RESTART), _fe(204_000, tev.EV_BOOT)],
    }


def test_exports_equal_reference_on_the_same_events():
    evs = _events()
    assert ttrace.lineage(evs) == jtrace.lineage(evs)
    assert ttrace.summary(evs) == jtrace.summary(evs)
    assert ttrace.to_chrome(evs, "tt") == jtrace.to_chrome(evs, "tt")
    assert ttrace.to_chrome(evs) == jtrace.to_chrome(evs)
    chains = ttrace.lineage(evs)
    assert [(t, n) for _, t, n, _ in chains[0]] == [
        ("verify", "consume"), ("verify", "publish"), ("dedup", "consume"),
        ("dedup", "publish"), ("sink", "consume")]
    # the per-hop latency: 200us - 160us on d_s, not from the origin
    row = next(ln for ln in ttrace.summary(evs).splitlines()
               if ln.startswith("d_s"))
    assert row.split()[2] == "40.0"


def test_exports_of_rings_equal_reference(wksps):
    """The same appends in both packages' rings, read back through each
    package's read_rings from a plan: equal events and equal exports."""
    out = []
    for rt, pkg, w in ((jrt, jtrace, wksps[0]), (trt, ttrace, wksps[1])):
        plan = {"links": {"a_b": {}, "b_c": {}}, "tiles": {}}
        for tn, recs in (("a", [(100, tev.EV_PUBLISH, 0, 0)]),
                         ("b", [(150, tev.EV_CONSUME, 0, 0),
                                (160, tev.EV_PUBLISH, 0, 1)]),
                         ("c", [(200, tev.EV_CONSUME, 0, 1)])):
            r = rt.TraceRing.create(w, 8)
            for ts, et, sig, link in recs:
                r.append(ts, et, sig=sig, link=link)
            plan["tiles"][tn] = {"trace_off": r.off, "trace_depth": 8}
        plan["tiles"]["u"] = {}
        evs = pkg.read_rings(plan, w)
        out.append((evs, pkg.to_chrome(evs), pkg.summary(evs),
                    pkg.lineage(evs)))
    assert out[1] == out[0]
    assert set(out[1][0]) == {"a", "b", "c"}


def test_blackbox_path_follows_the_ports_prefix():
    assert ttrace.blackbox_path("t", "sink") == \
        "/dev/shm/fdtt_t.blackbox.sink.json"
    assert jtrace.blackbox_path("t", "sink") == \
        "/dev/shm/fdtpu_t.blackbox.sink.json"


# -- build-time carving and the disabled path -------------------------------

def _build(trace=None, tiles=None, n=[0]):
    from firedancer_tpu_torch.disco import Topology
    n[0] += 1
    topo = Topology(f"ttb{os.getpid()}_{n[0]}", wksp_size=1 << 21,
                    trace=trace)
    topo.link("a_b", depth=32, mtu=256)
    topo.tile("a", "synth", outs=["a_b"], count=8, unique=4,
              **(tiles or {}).get("a", {}))
    topo.tile("b", "sink", ins=["a_b"], **(tiles or {}).get("b", {}))
    return topo.build()


def test_build_carves_rings_only_when_enabled():
    plan = _build()
    try:
        assert not any("trace_off" in s for s in plan["tiles"].values())
        assert plan["trace"] == trec.TRACE_DEFAULTS
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])
    plan = _build(trace={"enable": True, "depth": 128},
                  tiles={"a": {"trace": {"enable": False}},
                         "b": {"trace": {"sample": 4}}})
    try:
        assert "trace_off" not in plan["tiles"]["a"]
        b = plan["tiles"]["b"]
        assert (b["trace_depth"], b["trace_sample"]) == (128, 4)
        assert b["trace_off"] % 64 == 0
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])
    with pytest.raises(ValueError, match="unknown tile"):
        _build(trace={"enable": True, "tiles": ["ghost"]})
    with pytest.raises(ValueError, match="power of two"):
        _build(trace={"enable": True}, tiles={"b": {"trace": {"depth": 3}}})


def test_disabled_path_is_a_single_none_check():
    from firedancer_tpu_torch.disco.stem import Stem
    from firedancer_tpu_torch.disco.topo import TileCtx
    from firedancer_tpu_torch.runtime import CNC_HALT
    plan = _build()
    try:
        ctx = TileCtx(plan, "b")
        try:
            assert ctx.trace is None

            class _Tile:
                polls = 0

                def poll_once(self):
                    self.polls += 1
                    return 0

            stem = Stem(ctx, _Tile(), idle_sleep_s=0)
            assert stem._trace is None
            stem.run(max_iters=16)
            assert stem.tile.polls == 16 and ctx.cnc.state == CNC_HALT
        finally:
            ctx.close()
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])


def test_stem_records_boot_wait_work_housekeep_halt():
    """A traced tile's stem in this process: BOOT, one WAIT span per idle
    streak, WORK spans summing `sample` productive polls, HOUSEKEEP and
    HALT, oldest first."""
    from firedancer_tpu_torch.disco.stem import Stem
    from firedancer_tpu_torch.disco.topo import TileCtx
    plan = _build(trace={"enable": True, "depth": 64},
                  tiles={"b": {"trace": {"sample": 2}}})
    try:
        ctx = TileCtx(plan, "b")
        try:
            script = iter([0, 0, 3, 5, 0, 2, 1, 4])

            class _Tile:
                def poll_once(self):
                    return next(script, 0)

            Stem(ctx, _Tile(), idle_sleep_s=0).run(max_iters=8)
            evs = ttrace.read_rings(plan, ctx.wksp)["b"]
        finally:
            ctx.close()
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])
    names = [e["ev"] for e in evs]
    assert names[0] == "boot" and names[-1] == "halt"
    assert "housekeep" in names
    work = [e for e in evs if e["ev"] == "work"]
    assert [e["count"] for e in work] == [8, 3, 4]   # 3+5, 2+1, then 4
    assert [e["ev"] for e in evs if e["ev"] in ("wait", "work")] == \
        ["wait", "work", "wait", "work", "work"]


def test_config_toml_trace_section_roundtrip(tmp_path):
    from firedancer_tpu.app import config as jconfig
    from firedancer_tpu_torch.app import config as tconfig
    over = {"trace": {"enable": True, "depth": 256},
            "tile": [{"name": "sink", "trace": {"sample": 4}}]}
    topo = tconfig.build_topology(tconfig.load_config(TOML, overrides=over))
    ref = jconfig.build_topology(jconfig.load_config(TOML, overrides=over))
    assert topo.trace == ref.trace == {"enable": True, "depth": 256}
    assert topo.tiles["sink"].args["trace"] == {"sample": 4}
    bad = tconfig.load_config(TOML, overrides={"trace": {"enabled": True}})
    with pytest.raises(ValueError, match="did you mean 'enable'"):
        tconfig.build_topology(bad)


# -- a traced four-process pipeline -----------------------------------------

N_UNIQUE = 24


@pytest.fixture(scope="module")
def traced_pipeline():
    """cfg/sigverify.toml at 96 frames over 24 unique, verify on the CPU
    at batch 32, [trace] on: every tile's ring in shm."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco import TopologyRunner
    cfg = load_config(TOML, overrides={
        "trace": {"enable": True, "depth": 1024},
        "tile": [{"name": "synth", "count": 96, "unique": N_UNIQUE,
                  "burst": 32},
                 {"name": "verify", "device": "cpu", "batch": 32}]})
    runner = TopologyRunner(build_topology(
        cfg, name=f"ttrace{os.getpid()}").build()).start()
    try:
        runner.wait_running(timeout_s=240)
        runner.wait_idle("sink", "rx", N_UNIQUE, timeout_s=240)
        time.sleep(0.3)                        # one housekeeping flush
        yield runner
    finally:
        runner.halt(join_timeout_s=10)
        runner.close()


def test_lineage_verify_dedup_sink(traced_pipeline):
    runner = traced_pipeline
    evs = ttrace.read_rings(runner.plan, runner.wksp)
    assert set(evs) == {"synth", "verify", "dedup", "sink"}
    chains = ttrace.lineage(evs)
    hops = [("verify", "publish"), ("dedup", "consume"),
            ("dedup", "publish"), ("sink", "consume")]
    through = [sig for sig, c in chains.items()
               if all(h in [(t, n) for _, t, n, _ in c] for h in hops)]
    assert len(through) == N_UNIQUE
    for sig in through:
        # a publish record is stamped before its frags become visible, so
        # every hop sorts after the publish it follows
        seen = [(t, n) for _, t, n, _ in chains[sig]]
        assert [h for h in seen if h in hops] == hops, seen
    # the synth -> verify hop rides the synth's own sigs
    assert any(t == "synth" and n == "publish"
               for c in chains.values() for _, t, n, _ in c)
    verify = {e["ev"] for e in evs["verify"]}
    assert {"boot", "tpu_dispatch", "tpu_readback", "consume",
            "publish", "work"} <= verify
    text = ttrace.summary(evs)
    assert "verify_dedup" in text and "dedup_sink" in text
    doc = ttrace.to_chrome(evs, runner.plan["topology"])
    assert any(e.get("ph") == "f" for e in doc["traceEvents"])
    from firedancer_tpu_torch.disco.monitor import snapshot
    snap = snapshot(runner.plan, runner.wksp)
    assert snap["verify"]["trace"]["events"] > 0
    assert snap["verify"]["trace"]["depth"] == 1024


def test_cli_exports_live_and_after_the_halt(traced_pipeline, tmp_path,
                                             capsys):
    from firedancer_tpu_torch.trace.cli import main as trace_main
    runner = traced_pipeline
    name = runner.plan["topology"]
    live = tmp_path / "live.json"
    assert trace_main([name, "--out", str(live)]) == 0
    doc = json.loads(live.read_text())
    assert doc["otherData"] == {"topology": name, "source": "fdtrace"}
    assert any(e.get("name") == "tpu_dispatch" for e in doc["traceEvents"])
    assert "verify_dedup" in capsys.readouterr().out
    runner.halt(join_timeout_s=10)
    assert all(p.exitcode == 0 for p in runner.procs.values())
    after = tmp_path / "after.json"
    r = subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.trace", name,
         "--out", str(after), "--format", "both"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "dedup_sink" in r.stdout and "wrote" in r.stdout
    doc = json.loads(after.read_text())
    halts = {e["tid"] for e in doc["traceEvents"] if e.get("name") == "halt"}
    assert len(halts) == 4                     # every tile halted cleanly
    assert len(doc["traceEvents"]) >= len(
        json.loads(live.read_text())["traceEvents"])
