"""The port's SLO engine (firedancer_tpu_torch/disco/slo.py) against the
JAX package's: the [slo] schema and the expression grammar give the same
parse or the same error for a table of specs; under one fake clock fed
the same readings both engines give the same transitions, status and
breach history (the reference's tests/test_metrics.py:422-650); on a
built plan both read the same values off shared memory, resolve targets
alike, and a breach leaves an EV_SLO record and a dump that the
monitor's slo_breach_events recovers from shm alone."""
import json
import os

import numpy as np
import pytest

from firedancer_tpu.disco import slo as rslo
from firedancer_tpu.disco import monitor as rmonitor
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco import Topology
from firedancer_tpu_torch.disco import monitor as tmonitor
from firedancer_tpu_torch.disco import slo as tslo
from firedancer_tpu_torch.disco.metrics import HIST_U64
from firedancer_tpu_torch.runtime import Workspace

GOOD_SPECS = [
    None,
    {},
    {"fast_window_s": 1, "slow_window_s": 2, "burn_fast": 0.5,
     "burn_slow": 1.0},
    {"target": [{"name": "lat", "expr": "verify.work p99 < 500us"}]},
    {"target": [{"name": "r", "expr": "sink.rx rate > 1000/s",
                 "fast_window_s": 2.0, "burn_fast": 0.75}]},
    {"target": [{"name": "bp",
                 "expr": "link.a_b.backpressure rate < 1/s"}]},
    {"target": [{"name": "v", "expr": "sink.rx >= 3"},
                {"name": "w", "expr": "verify.tpu p50 <= 2ms"},
                {"name": "x", "expr": "verify.wait p90 > 1.5s"}]},
]

BAD_SPECS = [
    [1, 2],
    {"fast_windw_s": 1},
    {"fast_window_s": 0},
    {"burn_fast": 1.5},
    {"burn_slow": 0},
    {"fast_window_s": 120.0, "slow_window_s": 60.0},
    {"target": {"name": "x"}},
    {"target": ["x"]},
    {"target": [{"name": "x", "expr": "a.b > 1", "typo": 1}]},
    {"target": [{"expr": "a.b > 1"}]},
    {"target": [{"name": "x", "expr": "a.b > 1"},
                {"name": "x", "expr": "a.b > 2"}]},
    {"target": [{"name": "x"}]},
    {"target": [{"name": "x", "expr": "a.b > 1", "burn_fast": 1.5}]},
    {"target": [{"name": "x", "expr": "a.b > 1", "fast_window_s": -1}]},
    {"target": [{"name": "x", "expr": "a.b > 1", "fast_window_s": 90.0}]},
    {"target": [{"name": "x", "expr": "verify.work p98 < 1ms"}]},
]

BAD_EXPRS = [
    "verify.work p98 < 1ms", "verify.work p99 != 1ms",
    "verify.work p99 < 500", "sink.rx value > 100/s", "sink.rx > 5ms",
    "verify.work p99 < 1/s", "link.a_b rate < 1/s",
    "link.a_b.backpressure p99 < 1ms", "a.b.c > 1", "sink.rx", "a b c d e",
    "sink.rx > abc",
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS,
                         ids=[f"good{i}" for i in range(len(GOOD_SPECS))]
                         + [f"bad{i}" for i in range(len(BAD_SPECS))])
def test_normalize_slo_matches_reference(spec):
    got = _outcome(tslo.normalize_slo, spec)
    want = _outcome(rslo.normalize_slo, spec)
    assert got == want
    assert got[0] == ("ok" if spec in GOOD_SPECS else "error")


@pytest.mark.parametrize("expr", BAD_EXPRS + [
    "verify.work p99 < 500us", "sink.rx rate > 10/s", "sink.rx >= 3",
    "link.a_b.consumed value > 0", "verify.tpu p50 <= 0.5s",
    "verify.wait p90 > 100ns"])
def test_parse_expr_matches_reference(expr):
    assert _outcome(tslo.parse_expr, expr) == \
        _outcome(rslo.parse_expr, expr)


def test_schema_constants_match_reference():
    assert tslo.SLO_DEFAULTS == rslo.SLO_DEFAULTS
    assert tslo.TARGET_KEYS == rslo.TARGET_KEYS


def _engines(cfg, readings):
    """A port and a reference engine over one fake clock, both reading
    the scripted `readings` (a list consumed once per sample pass)."""
    plan = {"topology": "fake", "tiles": {"v": {}}, "links": {},
            "slo": cfg}
    clock = [0.0]
    out = []
    for mod in (tslo, rslo):
        eng = mod.SloEngine(plan, None, clock=lambda: clock[0],
                            dump=False)
        eng._read = lambda st, now, e=eng: float(readings[e.evals - 1])
        out.append(eng)
    return out, clock


@pytest.mark.parametrize("case", ["burn", "equal_windows", "flapping"])
def test_engine_events_status_history_match_reference(case):
    """The reference's burn-window drills (breach once the fast window
    is covered and all bad; clear once the fast window is clean and the
    slow window's bad fraction is under burn_slow; the acute path alive
    when both windows are equal) plus a flapping source, fed the same
    readings under one fake clock: the same transitions at the same
    passes, the same status and breach history at every pass."""
    if case == "burn":
        cfg = {"fast_window_s": 1.0, "slow_window_s": 4.0,
               "burn_fast": 1.0, "burn_slow": 0.5}
        readings = [2e6] * 9 + [5e5] * 20
        dt = 0.15
    elif case == "equal_windows":
        cfg = {"fast_window_s": 2.0, "slow_window_s": 2.0,
               "burn_fast": 0.5, "burn_slow": 1.0}
        readings = [2e6, 5e5] * 20
        dt = 0.13
    else:
        cfg = {"fast_window_s": 0.5, "slow_window_s": 2.0,
               "burn_fast": 0.8, "burn_slow": 0.6}
        rng = np.random.default_rng(7)
        readings = list(np.where(rng.random(120) < 0.55, 2e6, 5e5))
        dt = 0.05
    cfg["target"] = [{"name": "lat", "expr": "v.work p99 < 1ms"}]
    norm = tslo.normalize_slo(cfg)
    assert norm == rslo.normalize_slo(cfg)
    (port, ref), clock = _engines(norm, readings)
    kinds = []
    for _ in readings:
        got, want = port.sample(), ref.sample()
        assert got == want
        kinds += [e["kind"] for e in got]
        assert port.status() == ref.status()
        assert list(port.history) == list(ref.history)
        assert (port.breached, port.total_breaches, port.evals) == \
            (ref.breached, ref.total_breaches, ref.evals)
        clock[0] += dt
    if case == "burn":
        assert kinds == ["breach", "clear"]
    else:
        assert "breach" in kinds


def _plan(tag, slo, trace=None):
    topo = (Topology(f"tslo{tag}{os.getpid()}", wksp_size=1 << 22,
                     slo=slo, trace=trace)
            .link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4)
            .tile("b", "sink", ins=["a_b"])
            .tile("metric", "metric", port=0))
    return topo.build()


def test_engines_read_the_same_shm_values():
    """On a built plan, each source kind (a named metric slot with value
    and rate, a histogram quantile, a link counter summed over its
    consumers) reads the same in both engines, sample after sample."""
    cfg = {"fast_window_s": 0.3, "slow_window_s": 1.0, "target": [
        {"name": "rx", "expr": "b.rx > 5"},
        {"name": "rate", "expr": "b.rx rate > 10/s"},
        {"name": "lat", "expr": "b.work p90 < 1us"},
        {"name": "sup", "expr": "b.sup_restarts < 1"},
        {"name": "bp", "expr": "link.a_b.consumed rate > 1/s"}]}
    plan = _plan("shm", cfg)
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    try:
        clock = [0.0]
        engines = [mod.SloEngine(plan, w, clock=lambda: clock[0],
                                 dump=False) for mod in (tslo, rslo)]
        spec = plan["tiles"]["b"]
        mv = w.view(spec["metrics_off"], 64 * 8).view(np.uint64)
        hv = w.view(spec["hist_off"], 3 * HIST_U64 * 8).view(np.uint64)
        lv = w.view(spec["link_metrics"]["a_b"], 8 * 8).view(np.uint64)
        rng = np.random.default_rng(3)
        for i in range(24):
            mv[0] += int(rng.integers(0, 40))           # rx
            hv[HIST_U64 + 2 + int(rng.integers(5, 14))] += 1
            hv[HIST_U64] += 1                          # work count
            lv[0] += int(rng.integers(0, 3))            # consumed
            got, want = (e.sample() for e in engines)
            assert got == want
            assert engines[0].status() == engines[1].status()
            clock[0] += 0.1
        assert engines[0].evals == 24
    finally:
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])


@pytest.mark.parametrize("expr", [
    "ghost.rx > 1", "b.rxx > 1", "b.work2 p99 < 1ms",
    "link.nosuch.pub > 1", "link.a_b.pubb > 1", "b.rx > 1",
    "metric.slo_evals > 0", "link.a_b.overruns rate < 1/s"])
def test_resolve_slo_matches_reference(expr):
    """Targets resolve against the built plan's tiles, slots and links;
    the build refuses a dangling one with the reference's message."""
    cfg = tslo.normalize_slo({"target": [{"name": "t", "expr": expr}]})
    plan = _plan("res", None)
    try:
        got = _outcome(tslo.resolve_slo, cfg, plan)
        assert got == _outcome(rslo.resolve_slo, cfg, plan)
        if got[0] == "error":
            with pytest.raises(ValueError, match="slo target 't'"):
                _plan("res2", {"target": [{"name": "t", "expr": expr}]})
    finally:
        Workspace.unlink_name(plan["wksp"]["name"])


def test_breach_leaves_ev_slo_and_dump_the_monitor_recovers():
    """A breach through the port's engine with the metric tile's trace
    writer: an EV_SLO record naming the target, a dump at the port's
    path, and both packages' monitors recover the breach from shm."""
    from firedancer_tpu_torch.trace import writer_for
    cfg = {"fast_window_s": 0.2, "slow_window_s": 1.0, "target": [
        {"name": "never", "expr": "b.rx > 1000"}]}
    plan = _plan("ev", cfg, trace={"enable": True, "depth": 64})
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    path = tslo.slo_dump_path(plan["topology"], "never")
    try:
        clock = [0.0]
        eng = tslo.SloEngine(plan, w, clock=lambda: clock[0],
                             trace=writer_for(plan, w, "metric"))
        evs = []
        for _ in range(6):
            evs += eng.sample()
            clock[0] += 0.1
        assert [e["kind"] for e in evs] == ["breach"]
        assert evs[0]["dump"] == path
        assert path.startswith("/dev/shm/fdtt_")
        with open(path) as f:
            doc = json.load(f)
        assert doc["target"] == "never" and doc["kind"] == "breach"
        got = tmonitor.slo_breach_events(plan, w)
        assert [e["target"] for e in got] == ["never"]
        assert got == rmonitor.slo_breach_events(plan, w)
        assert "never" in tmonitor.format_slo_events(got)
        assert tmonitor.full_snapshot(plan, w)["slo_events"] == got
    finally:
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])
        if os.path.exists(path):
            os.unlink(path)


def test_config_loads_slo_and_merges_targets_by_name(tmp_path):
    """[[slo.target]] arrays merge by name across layers in both
    loaders; the port's cfg/flood.toml takes flood-demo's [slo] section
    and metric tile."""
    from firedancer_tpu.app import config as jconfig
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flood = os.path.join(root, "firedancer_tpu_torch", "cfg",
                         "flood.toml")
    over = {"slo": {"fast_window_s": 4.0, "target": [
        {"name": "flood-goodput", "expr": "sink.rx rate > 99/s"},
        {"name": "lat", "expr": "verify.work p99 < 5ms"}]}}
    got = tconfig.load_config(flood, overrides=over)["slo"]
    ref_cfg = jconfig.load_config(os.path.join(root, "cfg",
                                               "flood-demo.toml"),
                                  overrides=over)
    assert got == ref_cfg["slo"]
    assert [t["name"] for t in got["target"]] == ["flood-goodput", "lat"]
    port_tiles = {t["name"]: t for t in
                  tconfig.load_config(flood)["tile"]}
    ref_tiles = {t["name"]: t for t in jconfig.load_config(
        os.path.join(root, "cfg", "flood-demo.toml"))["tile"]}
    assert port_tiles["metric"] == ref_tiles["metric"]
    topo = tconfig.build_topology(tconfig.load_config(flood, overrides=over),
                                  name=f"tslocfg{os.getpid()}")
    plan = topo.build()
    try:
        assert [t["name"] for t in plan["slo"]["target"]] == \
            ["flood-goodput", "lat"]
        assert plan["slo"]["fast_window_s"] == 4.0
    finally:
        Workspace.unlink_name(plan["wksp"]["name"])
