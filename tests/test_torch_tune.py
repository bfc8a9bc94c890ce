"""The port's fdtune (firedancer_tpu_torch.tune, the knob mailbox, the
controller tile and the knob hooks) against the JAX package's on the
same inputs: the [tune] schema, the mailbox's bytes, the controller's
decisions under one scripted clock and pressure sequence on twin plans,
the sweep's results and state files (each package resuming the
other's), profiles both ways and FDTPU_TUNED_PROFILE, each adapter's
knob hook given the same posts, the reference's live drill on the
port's plan, and one process boot of cfg/tune.toml with verify on the
CPU, checked as chip_smoke.py's phase 27a and 27c check it on the card.

Nothing here reaches a Pallas kernel; every wait has a timeout and
every workspace is unlinked."""
import os
import time

import numpy as np
import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu import tune as jtune
from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco import Topology as RefTopology
from firedancer_tpu.disco import shed as jshed
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.tiles.verify import VerifyTile as RefVerifyTile
from firedancer_tpu.tune import controller as jctl
from firedancer_tpu.tune import profile as jprofile
from firedancer_tpu.tune import search as jsearch
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch import tune as ttune
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco import Topology
from firedancer_tpu_torch.disco import shed as tshed
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.tiles.verify import VerifyTile
from firedancer_tpu_torch.tune import controller as tctl
from firedancer_tpu_torch.tune import profile as tprofile
from firedancer_tpu_torch.tune import search as tsearch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "tune.toml")
_N = [0]


def _name(tag: str) -> str:
    _N[0] += 1
    return f"tt{tag}{os.getpid()}_{_N[0]}"


# -- [tune] schema ----------------------------------------------------------

ACCEPTED = [None, {}, {"interval_s": 0.5, "cooldown_s": 1.0},
            {"enable": False, "max_moves": 2, "window_s": 3.0},
            {"knob": {"coalesce_us": {"max": 800, "step": 50},
                      "pack_wave": {"default": 2}}}]
REJECTED = [{"intervals": 1}, {"interval_s": 0}, {"hysteresis": 1.5},
            {"interval_s": 2.0, "cooldown_s": 0.5}, {"max_moves": 0},
            {"knob": {"coalesce_u": {"max": 100}}},
            {"knob": {"coalesce_us": {"defalt": 100}}},
            {"knob": {"coalesce_us": {"min": 10, "max": 5}}},
            {"knob": {"pack_wave": {"default": 99}}},
            {"knob": {"pack_wave": {"step": 0}}}, "notatable",
            {"knob": []}]


@pytest.mark.parametrize("spec", ACCEPTED, ids=range(len(ACCEPTED)))
def test_normalize_tune_and_knob_space_equal_the_reference(spec):
    got, want = ttune.normalize_tune(spec), jtune.normalize_tune(spec)
    assert got == want
    assert ttune.knob_space(got) == jtune.knob_space(want)
    assert ttune.RUNTIME_KNOBS == jtune.RUNTIME_KNOBS
    assert ttune.KNOBS == jtune.KNOBS


@pytest.mark.parametrize("spec", REJECTED, ids=range(len(REJECTED)))
def test_normalize_tune_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError) as want:
        jtune.normalize_tune(spec)
    with pytest.raises(ValueError) as got:
        ttune.normalize_tune(spec)
    assert str(got.value) == str(want.value)


# -- the knob mailbox ------------------------------------------------------

POSTS = [(2, 500, 123), (2, 600, 0), (0, 7, 1 << 40), (5, 8, 99),
         (1, (1 << 64) - 1, 5), (2, 0, 6)]


def test_knob_mailbox_bytes_equal_the_reference():
    """The same post sequence leaves the same workspace bytes in both
    packages' mailboxes (footprint, slot order, write order)."""
    n = len(ttune.RUNTIME_KNOBS)
    assert trt.KnobMailbox.footprint(n) == jrt.KnobMailbox.footprint(n)
    wt = trt.Workspace(f"/fdtt_{_name('mb')}", 1 << 16)
    wj = jrt.Workspace(f"/fdtpu_{_name('mb')}", 1 << 16)
    try:
        mt, mj = trt.KnobMailbox.create(wt, n), jrt.KnobMailbox.create(wj, n)
        fp = trt.KnobMailbox.footprint(n)
        for idx, value, ts in POSTS:
            mt.post(idx, value, ts_ns=ts)
            mj.post(idx, value, ts_ns=ts)
            assert wt.view(mt.off, fp).tobytes() == \
                wj.view(mj.off, fp).tobytes()
            assert mt.read(idx) == mj.read(idx)
        gt, st = mt.snapshot()
        gj, sj = mj.snapshot()
        assert gt == gj == len(POSTS) and np.array_equal(st, sj)
        # a second join over the same offset reads the same state
        assert trt.KnobMailbox(wt, mt.off, n).read(2) == (0, 3)
        with pytest.raises(IndexError):
            mt.post(n, 1)
        with pytest.raises(ValueError):
            trt.KnobMailbox.create(wt, 0)
    finally:
        for w in (wt, wj):
            w.close()
            w.unlink()


# -- the controller, on twin plans ----------------------------------------

CALM = {"breached": 0, "burn": 0.0, "bp_delta": 0, "worst_link": None,
        "overloaded": False}
SATURATED = {"breached": 1, "burn": 1.0, "bp_delta": 500,
             "worst_link": "a_b", "overloaded": True}
CFG = {"enable": True, "interval_s": 0.25, "cooldown_s": 1.0,
       "recovery_s": 2.0, "hysteresis": 0.5, "max_moves": 3,
       "window_s": 4.0, "bp_ref": 100.0}


def _ticks(t0, t1, sample):
    t, out = t0, []
    while t < t1:
        out.append((t, dict(sample)))
        t += 0.25
    return out


def _flap():
    out = [(k * 0.25, dict(SATURATED if k % 2 else CALM))
           for k in range(48)]
    return out + _ticks(12.0, 32.0, CALM)


# the reference's scenarios (tests/test_tune.py:337-497): (cfg, polls)
SCENARIOS = {
    "step_load": (CFG, _ticks(0.0, 10.0, SATURATED)
                  + _ticks(10.0, 30.0, CALM)),
    "dead_band": (CFG, _ticks(0.0, 8.0, {**CALM, "bp_delta": 50})),
    "flapping_flood": (CFG, _flap()),
    "revert_no_overshoot": ({**CFG, "knob": {"coalesce_us": {"step": 300}}},
                            [(0.0, dict(SATURATED)), (100.0, dict(CALM)),
                             (102.1, dict(CALM))]),
    "status": (CFG, [(0.0, dict(SATURATED))]),
}


class _Probe:
    def __init__(self):
        self.sample = dict(CALM)

    def poll(self):
        return dict(self.sample)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _twin_plan(topo_cls, tune, trace=None, slo=None, metric=False):
    topo = topo_cls(_name("tw"), wksp_size=1 << 21, tune=tune, trace=trace,
                    slo=slo)
    topo.link("a_b", depth=32, mtu=256)
    topo.tile("src", "synth", outs=["a_b"], count=8, unique=4)
    topo.tile("dst", "sink", ins=["a_b"])
    if metric:
        topo.tile("metric", "metric", port=0)
    topo.tile("ctl", "controller")
    return topo.build()


def _drive(ctl_mod, rt, topo_cls, cfg, polls, monkeypatch):
    """One package's controller over its own twin plan, the scripted
    polls and a deterministic post clock. -> (decisions a poll, mailbox
    bytes, status, values)."""
    ns = iter(range(1, 1 << 20))
    monkeypatch.setattr(ctl_mod, "monotonic_ns", lambda: next(ns))
    plan = _twin_plan(topo_cls, cfg)
    w = rt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                     create=False)
    try:
        clock, probe = _Clock(), _Probe()
        c = ctl_mod.Controller(plan, w, cfg=dict(cfg), clock=clock,
                               probe=probe)
        out = []
        for t, sample in polls:
            clock.t, probe.sample = t, sample
            out.append(c.poll())
        fp = rt.KnobMailbox.footprint(len(plan["tune_knobs"]))
        raw = w.view(plan["tune_mailbox_off"], fp).tobytes()
        return out, raw, c.status(), dict(c.value), plan["tune_knobs"]
    finally:
        w.close()
        rt.Workspace.unlink_name(plan["wksp"]["name"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decisions_equal_the_reference(scenario, monkeypatch):
    cfg, polls = SCENARIOS[scenario]
    got = _drive(tctl, trt, Topology, cfg, polls, monkeypatch)
    want = _drive(jctl, jrt, RefTopology, cfg, polls, monkeypatch)
    assert got[0] == want[0]                       # every poll's decisions
    assert got[1] == want[1]                       # mailbox bytes
    assert got[2] == want[2] and got[3] == want[3] and got[4] == want[4]
    moves = [d for batch in got[0] for d in batch]
    if scenario == "dead_band":
        assert moves == []
    else:
        assert moves and moves[0]["why"] == "relief"
    if scenario in ("step_load", "flapping_flood"):
        space = ttune.knob_space(ttune.normalize_tune(cfg))
        assert got[3] == {n: space[n]["default"] for n in got[3]}
        assert any(d["why"] == "revert" for d in moves)


def test_controller_requires_the_mailbox():
    w = trt.Workspace(f"/fdtt_{_name('nm')}", 1 << 16)
    try:
        with pytest.raises(ValueError, match="no knob mailbox"):
            tctl.Controller({"tiles": {}}, w, cfg=dict(CFG))
    finally:
        w.close()
        w.unlink()


# -- the offline sweep -----------------------------------------------------

def _score(pt):
    return 1000.0 - abs(pt["coalesce_us"] - 400) * 0.1 \
        - abs(pt["verify_batch"] - 32)


@pytest.mark.parametrize("points", [2, 3, 5])
def test_sweep_result_and_state_equal_the_reference(tmp_path, points):
    res = {}
    for tag, mod in (("port", tsearch), ("ref", jsearch)):
        state = str(tmp_path / f"{tag}.json")
        calls = []
        res[tag] = mod.run_sweep(lambda pt: calls.append(pt) or _score(pt),
                                 state, points=points)
        res[tag]["calls"] = calls
        res[tag].pop("state_path")
        with open(state, "rb") as f:
            res[tag]["state"] = f.read()
    assert res["port"] == res["ref"]
    assert res["port"]["tuned_vs_default_tps"] >= 1.0
    # each package resumes the other's state file, measuring nothing
    for tag, mod in (("ref", tsearch), ("port", jsearch)):
        state = str(tmp_path / f"{tag}.json")
        again = mod.run_sweep(lambda pt: pytest.fail(f"re-measured {pt}"),
                              state, points=points)
        assert again["measured"] == 0
        assert again["knobs"] == res[tag]["knobs"]
    # a killed sweep resumes from the reference's checkpoint
    state = str(tmp_path / "killed.json")
    done = []

    def dying(pt):
        if len(done) == 2:
            raise RuntimeError("killed")
        done.append(pt)
        return _score(pt)
    with pytest.raises(RuntimeError):
        jsearch.run_sweep(dying, state, points=points)
    rest = tsearch.run_sweep(_score, state, points=points)
    assert rest["measured"] == res["ref"]["measured"] - 2
    assert rest["knobs"] == res["ref"]["knobs"]
    assert tsearch.axis_candidates(ttune.knob_space(None)["coalesce_us"],
                                   points) == jsearch.axis_candidates(
        jtune.knob_space(None)["coalesce_us"], points)
    with pytest.raises(ValueError, match="unknown knob axis"):
        tsearch.run_sweep(_score, state, axes=("coalesce_us", "warp"))


# -- tuned profiles ---------------------------------------------------------

PROFILE_CFG = {"link": [{"name": "a_b", "depth": 64, "mtu": 1280},
                        {"name": "b_c", "depth": 64, "mtu": 1280}],
               "tile": [{"name": "src", "kind": "synth", "outs": ["a_b"]},
                        {"name": "v", "kind": "verify", "ins": ["a_b"],
                         "outs": ["b_c"], "batch": 32},
                        {"name": "vb", "kind": "verify", "ins": ["a_b"],
                         "outs": ["b_c2"], "mode": "bulk_prefilter"},
                        {"name": "dst", "kind": "sink", "ins": ["b_c"]},
                        {"name": "dst2", "kind": "sink", "ins": ["b_c2"]}]}
PROFILE_CFG["link"].append({"name": "b_c2", "depth": 64, "mtu": 1280})
KNOBS = {"coalesce_us": 700, "verify_batch": 64, "shed_tighten": 2,
         "bulk_prefilter": 1}


def test_profiles_load_across_packages_and_seed_the_same_args(
        tmp_path, monkeypatch):
    paths = {}
    for tag, mod in (("port", tprofile), ("ref", jprofile)):
        doc = mod.make_profile(KNOBS, 1100.0, 1000.0, sweep={"count": 64})
        paths[tag] = mod.save_profile(doc, str(tmp_path / f"{tag}.json"))
    got = jprofile.load_profile(paths["port"])       # port's, by the ref
    want = tprofile.load_profile(paths["ref"])       # ref's, by the port
    assert got["knobs"] == want["knobs"] == KNOBS
    assert got["measured"] == want["measured"]
    assert got["host"]["backend"] == "cpu" and "devices" in got["host"]
    assert tprofile.diff_profiles(got, want) == \
        jprofile.diff_profiles(got, want) == {}
    other = tprofile.make_profile({"coalesce_us": 200}, 1.0, 1.0)
    assert tprofile.diff_profiles(got, other) == \
        jprofile.diff_profiles(got, other)
    assert tprofile.KNOB_ARGS == jprofile.KNOB_ARGS
    # apply_profile and the environment seed the same tile args as the
    # reference's on the same config
    tt = tconfig.build_topology(PROFILE_CFG)
    jt = jconfig.build_topology(PROFILE_CFG)
    assert tprofile.apply_profile(tt, got) == \
        jprofile.apply_profile(jt, got)
    assert {n: t.args for n, t in tt.tiles.items()} == \
        {n: t.args for n, t in jt.tiles.items()}
    monkeypatch.setenv("FDTPU_TUNED_PROFILE", paths["ref"])
    tt = tconfig.build_topology(PROFILE_CFG)
    jt = jconfig.build_topology(PROFILE_CFG)
    assert {n: t.args for n, t in tt.tiles.items()} == \
        {n: t.args for n, t in jt.tiles.items()}
    assert tt.tiles["v"].args["coalesce_us"] == 700
    assert tt.tiles["vb"].args["prefilter_shed"] is True
    with pytest.raises(ValueError, match="unknown knob"):
        tprofile.make_profile({"warp_factor": 9}, 1.0, 1.0)


# -- the knob hooks, each adapter against the reference's -----------------

class _Ctx:
    def __init__(self, knobs):
        self.knobs = knobs


class _Stub:
    def poll(self):
        pass


def _readers(kind):
    """One KnobReader a package over its own twin plan's mailbox, for a
    tile of `kind`; -> (port reader, ref reader, post(name, value),
    close)."""
    pt, pj = _twin_plan(Topology, {}), _twin_plan(RefTopology, {})
    wt = trt.Workspace(pt["wksp"]["name"], pt["wksp"]["size"], create=False)
    wj = jrt.Workspace(pj["wksp"]["name"], pj["wksp"]["size"], create=False)
    for p in (pt, pj):
        p["tiles"]["x"] = {"kind": kind}
    rt, rj = ttune.reader_for(pt, wt, "x"), jtune.reader_for(pj, wj, "x")
    assert set(rt.knobs) == set(rj.knobs)
    names = pt["tune_knobs"]
    mt = trt.KnobMailbox(wt, pt["tune_mailbox_off"], len(names))
    mj = jrt.KnobMailbox(wj, pj["tune_mailbox_off"], len(names))

    def post(name, value):
        mt.post(names.index(name), value)
        mj.post(names.index(name), value)

    def close():
        for w, p, rt_ in ((wt, pt, trt), (wj, pj, jrt)):
            w.close()
            rt_.Workspace.unlink_name(p["wksp"]["name"])
    return rt, rj, post, close


def _verify_tile(cls, mode):
    t = type("T", (), {"set_coalesce_ns": cls.set_coalesce_ns,
                       "_flush_hold": lambda self: None})()
    t._coalesce_ns, t._hold_n, t._hold_buf = 0, 0, None
    t.batch, t.max_len, t.mode, t.prefilter_shed = 8, 64, mode, True
    return t


@pytest.mark.parametrize("mode", ["strict", "bulk_prefilter"])
def test_verify_knob_hook_equals_the_reference(mode):
    rt, rj, post, close = _readers("verify")
    try:
        ads = []
        for cls, tcls, rd in ((ttiles.VerifyAdapter, VerifyTile, rt),
                              (jtiles.VerifyAdapter, RefVerifyTile, rj)):
            a = object.__new__(cls)
            a.ctx, a.tile = _Ctx(rd), _verify_tile(tcls, mode)
            a._compile_watch, a._capture = _Stub(), None
            ads.append(a)
        seen = []
        for name, value in ((None, None), ("coalesce_us", 300),
                            ("bulk_prefilter", 0), ("coalesce_us", 0),
                            ("bulk_prefilter", 1), ("coalesce_us", 1000)):
            if name is not None:
                post(name, value)
            states = []
            for a in ads:
                a.housekeeping()
                states.append((a.tile._coalesce_ns, a.tile.prefilter_shed,
                               a.tile._hold_buf is None))
            assert states[0] == states[1]
            seen.append(states[0])
        assert seen[1][0] == 300_000 and seen[-1][0] == 1_000_000
        assert seen[2][1] is (mode == "strict")
    finally:
        close()


@pytest.mark.parametrize("kind,knob,attr", [("pack", "pack_wave", "wave"),
                                            ("bank", "bank_wave", "wave"),
                                            ("exec", "exec_dispatch",
                                             "batch")])
def test_wave_and_dispatch_knob_hooks_equal_the_reference(kind, knob, attr):
    rt, rj, post, close = _readers(kind)
    try:
        ads = []
        for mod, rd in ((ttiles, rt), (jtiles, rj)):
            a = object.__new__(mod.REGISTRY[kind])
            a.ctx, a.slot_in = _Ctx(rd), ["poh_slots"]
            setattr(a, attr, 5)
            ads.append(a)
        for value in (None, 9, 0, 32, 1):
            if value is not None:
                post(knob, value)
            for a in ads:
                a.housekeeping()
            assert getattr(ads[0], attr) == getattr(ads[1], attr) == \
                (5 if value is None else max(1, value))
    finally:
        close()


def test_peer_gate_tighten_admits_as_the_reference():
    cfg = {"rate_pps": 100.0, "burst": 4, "max_peers": 8, "min_stake": 1,
           "stakes": {"10.0.0.1:1": 5}}
    gates = [tshed.PeerGate(cfg), jshed.PeerGate(cfg)]
    rng = np.random.default_rng(23)
    now = 1_000_000_000
    got = []
    for step in range(600):
        if step % 97 == 0:
            level = int(rng.integers(0, 9))
            for g in gates:
                g.set_tighten(level)
            assert gates[0].rate == gates[1].rate == 100.0 / (1 + level)
        if step == 300:
            for g in gates:
                g.trip_overload(now)
        now += int(rng.integers(0, 20_000_000))
        addr = (f"10.0.0.{int(rng.integers(1, 4))}", 1)
        res = [g.admit(addr, now) for g in gates]
        assert res[0] == res[1], step
        got.append(res[0])
    assert 0 < sum(got) < len(got)
    assert gates[0].shed_total == gates[1].shed_total > 0


def test_shed_slo_poll_passes_the_tighten_level():
    """The ingest doors' housekeeping (sock, quic, gossip, repair) hands
    the posted shed_tighten level to their gate, as the reference's."""
    rt, rj, post, close = _readers("sock")
    try:
        doors = []
        for mod, sh, rd in ((ttiles, tshed, rt), (jtiles, jshed, rj)):
            ctx = _Ctx(rd)
            ctx.plan, ctx.wksp = {"tiles": {}, "links": {}}, None
            doors.append((mod, ctx, sh.PeerGate({"rate_pps": 80.0})))
        for level, rate in ((None, 80.0), (3, 20.0), (0, 80.0)):
            if level is not None:
                post("shed_tighten", level)
            for mod, ctx, g in doors:
                mod._shed_slo_poll(ctx, g)
                assert g.rate == rate and not g.overloaded()
    finally:
        close()


# -- the reference's live drill, on the port's plan -----------------------

def test_live_drill_on_the_port_plan():
    """tests/test_tune.py:635-719 less its gui half: an SLO breach and
    link backpressure written into the port's shm drive the controller
    on a scripted clock; the mailbox carries the relief, EV_TUNE lands
    in the ring with the saturating hop, and the knobs recover."""
    from firedancer_tpu_torch.disco.metrics import LINK_PROD_COUNTERS
    from firedancer_tpu_torch.disco.slo import PressureProbe
    from firedancer_tpu_torch.disco.topo import METRICS_SLOTS
    from firedancer_tpu_torch.flight.recorder import _TRACE_KEEP
    from firedancer_tpu_torch.trace import export, writer_for
    from firedancer_tpu_torch.trace.events import EV_TUNE
    plan = _twin_plan(
        Topology, {**CFG}, metric=True, trace={"enable": True, "depth": 256},
        slo={"fast_window_s": 2.0,
             "target": [{"name": "bp",
                         "expr": "link.a_b.backpressure rate < 100/s"}]})
    w = trt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                      create=False)
    try:
        tw = writer_for(plan, w, "ctl")
        clock = _Clock()
        c = tctl.Controller(plan, w, cfg=plan["tune"], clock=clock,
                            trace=tw, probe=PressureProbe(plan, w))
        assert c.poll() == []
        mview = w.view(plan["tiles"]["metric"]["metrics_off"],
                       METRICS_SLOTS * 8).view(np.uint64)
        names = plan["tiles"]["metric"]["metrics_names"]
        mview[names.index("slo_breach")] = 1
        mview[names.index("slo_breaches")] = 1
        lview = w.view(plan["links"]["a_b"]["prod_metrics_off"],
                       len(LINK_PROD_COUNTERS) * 8).view(np.uint64)
        lview[LINK_PROD_COUNTERS.index("backpressure")] = 500
        clock.t = 0.5
        moved = c.poll()
        assert moved and all(d["why"] == "relief" for d in moved)
        assert moved[0]["worst_link"] == "a_b"
        evs = [e for e in export.read_rings(plan, w, tiles=["ctl"])["ctl"]
               if e["etype"] == EV_TUNE]
        assert len(evs) == len(moved) and evs[0]["link"] == "a_b"
        assert evs[0]["arg"] == c.value[plan["tune_knobs"][evs[0]["count"]]]
        mview[names.index("slo_breach")] = 0
        space = ttune.knob_space(plan["tune"])
        t = clock.t
        while clock.t < t + 30.0:
            clock.t += 0.25
            c.poll()
        assert c.value == {n: space[n]["default"] for n in c.names}
        assert c.reverts > 0 and "tune" in _TRACE_KEEP
    finally:
        w.close()
        trt.Workspace.unlink_name(plan["wksp"]["name"])


# -- cfg/tune.toml as processes, verify on the CPU -------------------------

def test_tune_toml_boot_on_the_cpu(tmp_path, capsys):
    """cfg/tune.toml with verify on the CPU and the synth cut to 4,096
    frames, booted as chip_smoke.py's 27a boots it (the synth once every
    other tile runs): the controller relieves while the synth runs, one
    EV_TUNE a decision in its ring, at most max_moves in any window_s,
    every knob back at its default within 30 s of calm, the pipeline
    exact; then 27c's post-mortem from the archive alone."""
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    from firedancer_tpu_torch.disco.slo import slo_dump_path
    from firedancer_tpu_torch.flight import cli as flight_cli
    from firedancer_tpu_torch.flight.archive import (cumulative,
                                                     read_frames, series)
    from firedancer_tpu_torch.flight.codec import KIND_MARK
    from firedancer_tpu_torch.trace.export import read_rings
    from firedancer_tpu_torch.trace.events import EV_TUNE
    from firedancer_tpu_torch.tune import cli as tune_cli
    d = str(tmp_path / "flight")
    cfg = tconfig.load_config(TUNE_TOML, overrides={
        "flight": {"dir": d},
        "tile": [{"name": "synth", "count": 4096},
                 {"name": "verify", "device": "cpu"},
                 {"name": "controller", "trace": {"depth": 1 << 14}}]})
    name = _name("td")
    runner = TopologyRunner(tconfig.build_topology(cfg, name=name).build())
    plan = runner.plan
    names = plan["tune_knobs"]
    space = ttune.knob_space(plan["tune"])
    mb = trt.KnobMailbox(runner.wksp, plan["tune_mailbox_off"], len(names))
    try:
        runner.start([tn for tn in plan["tiles"] if tn != "synth"])
        runner.wait_running(timeout_s=120)
        runner.start(["synth"])
        runner.wait_running(timeout_s=60)
        runner.wait_idle("synth", "tx", 4096, timeout_s=60)
        runner.wait_idle("sink", "rx", 64, timeout_s=60)
        c = runner.metrics("controller")
        assert c["decisions"] - c["reverts"] > 0, c
        deadline = time.time() + 60
        while runner.metrics("controller")["breached"] or \
                runner.metrics("controller")["pressure_pct"]:
            runner.check_failures()
            assert time.time() < deadline
            time.sleep(0.05)
        calm = time.time()
        while any(seq and value != space[n]["default"]
                  for n, (value, seq) in ((n, mb.read(i))
                                          for i, n in enumerate(names))):
            runner.check_failures()
            assert time.time() - calm < 30.0, \
                [mb.read(i) for i in range(len(names))]
            time.sleep(0.05)
        slots = [mb.read(i) for i in range(len(names))]
        runner.halt(tiles=[tn for tn in plan["tiles"] if tn != "flight"])
        runner.halt()
        assert all(p.exitcode == 0 for p in runner.procs.values())
        m = {tn: runner.metrics(tn)
             for tn in ("verify", "sink", "controller")}
        evs = [e for e in read_rings(plan, runner.wksp,
                                     tiles=["controller"])["controller"]
               if e["etype"] == EV_TUNE]
    finally:
        runner.halt()
        runner.close()
        try:
            os.unlink(slo_dump_path(name, "ingest-backpressure"))
        except OSError:
            pass
    v = m["verify"]
    assert m["sink"]["rx"] == 64 and v["batches"] > 0
    assert v["verify_fail"] == v["parse_fail"] == v["cpu_fallback"] == 0
    assert m["controller"]["reverts"] > 0
    assert len(evs) == m["controller"]["decisions"]
    for i, (value, seq) in enumerate(slots):
        mine = [e["arg"] for e in evs if e["count"] == i]
        assert len(mine) == seq and (not mine or mine[-1] == value)
    ts = [e["ts"] for e in evs]
    w_ns = plan["tune"]["window_s"] * 1e9
    assert max(sum(1 for u in ts if t - w_ns < u <= t) for t in ts) \
        <= plan["tune"]["max_moves"]
    assert {e["link"] for e in evs} <= {None, *plan["links"]}
    # 27c: the archive alone
    capsys.readouterr()
    assert tune_cli.main(["watch", d]) == 0
    watched = [tuple(ln.split(": ", 1)[1].split(" -> "))
               for ln in capsys.readouterr().out.splitlines()]
    assert [(k, int(x)) for k, x in watched] == \
        [(names[e["count"]], e["arg"]) for e in evs]
    assert flight_cli.main(["summary", d]) == 0
    assert " 0 torn/dropped" in capsys.readouterr().out
    frames, dropped = read_frames(d)
    marks = [f["name"] for f in frames if f["kind"] == KIND_MARK]
    assert dropped == 0 and marks[0] == "boot" and marks[-1] == "halt"
    assert cumulative(series(frames, "sink", "rx"))[-1][1] == \
        m["sink"]["rx"]
