"""The port's topology layer (firedancer_tpu_torch.disco, .app) against
the JAX package's: Topology's validation, the config loaders on the
port's TOML, the refusals of what the port has not ported, the ring
telemetry counters, the metric readers and monitor on the same shm, the
supervisor's policy engine on fake processes, and the four-process
pipeline synth -> verify (device="cpu", the kernels' plain
versions) -> dedup -> sink over shm, whose output ring must hold, byte
for byte and in order, what the reference's in-process VerifyTile
followed by one tcache insert-or-drop gives on the same frames and seed.

Every wait has a timeout, and every runner is halted and closed."""
import dataclasses
import os
import time

import pytest
import torch

from firedancer_tpu import runtime as jrt
from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco import Topology as RefTopology
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.lint import registry as jregistry
from firedancer_tpu.tiles.verify import VerifyTile as RefVerifyTile
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.app import run as trun
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.disco.monitor import attach, format_table, snapshot
from firedancer_tpu_torch.disco.stem import Stem
from firedancer_tpu_torch.disco.unported import (
    UNPORTED_KINDS, UNPORTED_SECTIONS, UNPORTED_TILE_ARGS)
from firedancer_tpu_torch.tiles import synth as tsynth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "sigverify.toml")
N_UNIQUE = 24
N_SENT = 48
BATCH = 16
SEED = bytes(range(16))
WAIT_S = 120.0


def _name(tag: str) -> str:
    return f"tt{tag}{os.getpid()}"


def _wait(cond, timeout_s: float, runner=None, what: str = ""):
    deadline = time.time() + timeout_s
    while not cond():
        if runner is not None:
            runner.check_failures()
        if time.time() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _ring_frames(rt, wksp, li: dict):
    """(payload, sig) of every frag still in a ring, from seq 0."""
    ring = rt.Ring(wksp, li["ring_off"], li["depth"], li["arena_off"],
                   li["mtu"])
    out, seq = [], 0
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out
        out.append((bytes(ring.payload(frag)), int(frag.sig)))
        seq += 1


# -- topology validation (tests/test_topo.py:198-212) --------------------

@pytest.mark.parametrize("build,match", [
    (lambda T: T("tv1").link("l").tile("a", "synth", outs=["l"])
     .tile("b", "synth", outs=["l"]).tile("c", "sink", ins=["l"]),
     "two producers"),
    (lambda T: T("tv2").link("l").tile("c", "sink", ins=["l"]),
     "no producer"),
    (lambda T: T("tv3").link("l").tile("a", "synth", outs=["l"]),
     "no consumer"),
    (lambda T: T("tv4").tile("a", "synth", outs=["zzz"]), "unknown"),
], ids=["two_producers", "no_producer", "no_consumer", "unknown_link"])
def test_validate_errors_match_reference(build, match):
    for T in (RefTopology, Topology):
        with pytest.raises(ValueError, match=match):
            build(T)._validate()


# -- the port's TOML through both config loaders ------------------------

def _specs(topo) -> dict:
    return {"links": {n: dataclasses.asdict(s)
                      for n, s in topo.links.items()},
            "tcaches": dict(topo.tcaches),
            "tiles": {n: dataclasses.asdict(s)
                      for n, s in topo.tiles.items()}}


@pytest.mark.parametrize("overrides", [
    None,
    {"tile": [{"name": "verify", "mode": "bulk_prefilter",
               "tile_cnt": 2, "outs": ["vd0", "vd1"],
               "tcache": ["verify_tc", "tc1"]},
              {"name": "dedup", "ins": ["vd0", "vd1"]}],
     "link": [{"name": "vd0"}, {"name": "vd1"}],
     "tcache": [{"name": "tc1", "depth": 64}]},
], ids=["sigverify", "sharded_prefilter"])
def test_toml_builds_the_same_topology_under_both_loaders(overrides):
    want = _specs(jconfig.build_topology(
        jconfig.load_config(TOML, overrides=overrides)))
    got = _specs(tconfig.build_topology(
        tconfig.load_config(TOML, overrides=overrides)))
    assert got == want
    assert set(got["tiles"]) >= {"synth", "dedup", "sink"}


# -- refusals -----------------------------------------------------------

@pytest.mark.parametrize("section", sorted(UNPORTED_SECTIONS))
def test_unported_section_is_refused_with_its_item(section):
    item = f"queue A item {UNPORTED_SECTIONS[section]}"
    cfg = tconfig.load_config(TOML, overrides={section: {}})
    with pytest.raises(NotImplementedError, match=item):
        tconfig.build_topology(cfg)


@pytest.mark.parametrize("kind", sorted(UNPORTED_KINDS))
def test_unported_kind_is_refused_with_its_item(kind):
    item = f"queue A item {UNPORTED_KINDS[kind]}"
    with pytest.raises(NotImplementedError, match=item):
        Topology("tk").tile("t", kind)
    # through the config gate too: the kind passes it and is refused
    with pytest.raises(NotImplementedError, match=item):
        tconfig.build_topology({"tile": [{"name": "t", "kind": kind}]})


def test_every_reference_kind_is_ported_or_refused():
    assert set(ttiles.REGISTRY) == {"synth", "verify", "dedup", "sink",
                                    "pack", "bank", "poh", "shred",
                                    "sign", "replay", "sock", "gossip",
                                    "exec", "resolv", "metric"}
    assert set(jtiles.REGISTRY) == set(ttiles.REGISTRY) | set(UNPORTED_KINDS)
    with pytest.raises(ValueError, match="unknown tile kind"):
        ttiles.adapter_class("nosuch_kind")
    with pytest.raises(ValueError, match="unknown kind"):
        tconfig._validate_tile_keys({"name": "t", "kind": "nosuch_kind"})


@pytest.mark.parametrize("arg,item", sorted(UNPORTED_TILE_ARGS.items()))
def test_unported_tile_arg_is_refused_with_its_item(arg, item):
    """Refused in Topology.tile, whether the arg comes from code, from
    the config gate (which accepts it on the shred tile, as the
    reference's does) or through sharded_tile. Core pinning, the lazy
    cadence and the prof override are ported
    (tests/test_torch_placement.py, tests/test_torch_prof.py)."""
    match = f"queue A item {item}"
    with pytest.raises(NotImplementedError, match=match):
        Topology("ta").tile("a", "shred", **{arg: 1})
    with pytest.raises(NotImplementedError, match=match):
        tconfig.build_topology(
            {"tile": [{"name": "s", "kind": "shred", arg: 1}]})
    with pytest.raises(NotImplementedError, match=match):
        Topology("ta").sharded_tile("s", "shred", 2, outs=["a", "b"],
                                    **{arg: 1})


def test_config_gate_accepts_the_reference_keys_plus_device():
    for kind, keys in tconfig.TILE_ARGS.items():
        ref = jregistry.known_keys(kind)
        port = {"name", "kind", "ins", "outs", *tconfig.COMMON_KEYS,
                *keys}
        on_card = kind in ("verify", "bank", "replay", "gossip", "exec")
        assert port - ref == ({"device"} if on_card else set())
        assert ref <= port


# -- multi-process ------------------------------------------------------

def test_fail_fast_on_tile_death():
    """A tile whose kind is no kind dies at boot; the supervisor tears
    the topology down (tests/test_topo.py:109)."""
    topo = (Topology(_name("ff"), wksp_size=1 << 22)
            .link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4, unique=4)
            .tile("b", "nosuch_kind", ins=["a_b"]))
    runner = TopologyRunner(topo.build()).start()
    try:
        with pytest.raises(RuntimeError, match="died"):
            _wait(lambda: False, WAIT_S, runner, "the dead tile")
    finally:
        runner.halt(join_timeout_s=5)
        runner.close()


def _primed_frames(txns):
    """Frames published into the ingest ring before the synth starts:
    corrupted signatures (each with a changed message, so its dedup tag
    is its own), a duplicate of a corrupted one and an unparseable
    payload (tests/test_torch_verify_tile.py::_frames)."""
    out = []
    for i in (2, 9, 17):
        bad = bytearray(txns[i])
        bad[3 + i] ^= 1                # inside signature 0
        bad[-1] ^= 1                   # message, so the tag differs
        out.append(bytes(bad))
    return out + [out[-1], b"\xff\x00garbage"]


def _reference(frames):
    """The reference's in-process VerifyTile (tcache depth 8, batch
    BATCH, seed SEED) then one tcache insert-or-drop on its out ring.
    -> ((payload, sig) list, verify metrics, dedup dups)."""
    w = jrt.Workspace(f"/fdtpu_ttref{os.getpid()}", 1 << 24)
    try:
        in_ring = jrt.Ring.create(w, depth=128, mtu=1280)
        out_ring = jrt.Ring.create(w, depth=128, mtu=1280)
        tile = RefVerifyTile(in_ring, out_ring, jrt.Tcache(w, depth=8),
                             batch=BATCH, dedup_seed=SEED)
        for i, f in enumerate(frames):
            in_ring.publish(f, sig=i)
        while tile.poll_once():
            pass
        tile.flush()
        li = {"ring_off": out_ring.off, "depth": out_ring.depth,
              "arena_off": out_ring.arena_off, "mtu": out_ring.mtu}
        dedup = jrt.Tcache(w, depth=4096)
        out, dups = [], 0
        for payload, sig in _ring_frames(jrt, w, li):
            if dedup.insert(sig):
                dups += 1
            else:
                out.append((payload, sig))
        return out, dict(tile.metrics), dups
    finally:
        w.close()
        w.unlink()


@pytest.fixture(scope="module")
def pipeline():
    """synth -> verify -> dedup -> sink, four OS processes. The verify
    tcache has depth 8 < 24 unique txns, so duplicates leak past verify
    and the dedup tile drops them: both dedup layers act."""
    txns = tsynth.make_signed_txns(N_UNIQUE, seed=3)
    primed = _primed_frames(txns)
    frames = primed + [txns[i % N_UNIQUE] for i in range(N_SENT)]
    ref = _reference(frames)
    topo = (Topology(_name("p"), wksp_size=1 << 24)
            .link("synth_verify", depth=64, mtu=1280)
            .link("verify_dedup", depth=64, mtu=1280)
            .link("dedup_sink", depth=64, mtu=1280)
            .tcache("verify_tc", depth=8)
            .tcache("dedup_tc", depth=4096)
            .tile("synth", "synth", outs=["synth_verify"],
                  count=N_SENT, unique=N_UNIQUE, seed=3)
            .tile("verify", "verify", ins=["synth_verify"],
                  outs=["verify_dedup"], batch=BATCH, tcache="verify_tc",
                  device="cpu")
            .tile("dedup", "dedup", ins=["verify_dedup"],
                  outs=["dedup_sink"], tcache="dedup_tc")
            .tile("sink", "sink", ins=["dedup_sink"]))
    plan = topo.build()
    plan["seed"] = SEED.hex()
    w = trt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                      create=False)
    li = plan["links"]["synth_verify"]
    ingest = trt.Ring(w, li["ring_off"], li["depth"], li["arena_off"],
                      li["mtu"])
    for i, f in enumerate(primed):
        ingest.publish(f, sig=i)
    w.close()
    runner = TopologyRunner(plan)
    try:
        runner.start().wait_running(timeout_s=WAIT_S)
        want_drops = ref[1]["dedup_drop"] + ref[2]

        def done():
            v, d = runner.metrics("verify"), runner.metrics("dedup")
            return (runner.metrics("sink")["rx"] >= len(ref[0])
                    and v["rx"] == len(frames)
                    and v["dedup_drop"] + d["dup"] >= want_drops)
        _wait(done, WAIT_S, runner, "the pipeline to drain")
        yield runner, frames, ref
    finally:
        runner.halt()
        runner.close()


def test_pipeline_matches_reference_verify_and_dedup(pipeline):
    runner, frames, (want, ref_m, ref_dups) = pipeline
    got = _ring_frames(trt, runner.wksp, runner.plan["links"]["dedup_sink"])
    assert got == want
    assert len(want) == N_UNIQUE
    s, v, d, k = (runner.metrics(t)
                  for t in ("synth", "verify", "dedup", "sink"))
    assert s["tx"] == N_SENT
    assert v["rx"] == len(frames)
    for key in ("rx", "verify_fail", "parse_fail"):
        assert v[key] == ref_m[key], key
    assert (v["verify_fail"], v["parse_fail"]) == (4, 1)
    # the split between the two dedup layers depends on timing
    assert v["dedup_drop"] + d["dup"] == ref_m["dedup_drop"] + ref_dups
    assert d["dup"] > 0
    assert k["rx"] == len(want)
    assert k["bytes"] == sum(len(p) for p, _ in want)
    assert v["device_errors"] == 0 and v["batches"] > 0


def test_pipeline_heartbeats_live_and_monitor(pipeline):
    runner = pipeline[0]
    hb1 = runner.heartbeats()
    time.sleep(0.1)
    hb2 = runner.heartbeats()
    tiles = {"synth", "verify", "dedup", "sink"}
    assert set(hb1) == set(hb2) == tiles
    # synth/dedup/sink heartbeat every ~10 ms; the verify tile between
    # polls, each a few seconds of plain-version verify on the CPU
    for tn, age in hb2.items():
        assert age < (30 if tn == "verify" else 2) * 10**9, tn
    plan, wksp = attach(runner.plan["topology"])
    try:
        snap = snapshot(plan, wksp)
    finally:
        wksp.close()
    assert set(snap) == tiles
    assert all(row["state"] == "run" for row in snap.values())
    assert snap["sink"]["metrics"]["rx"] == N_UNIQUE
    table = format_table(snap)
    assert "verify" in table and "rx=" in table


def test_sharded_verify_forwards_every_unique_frame_once():
    """tile_cnt = 2 from config: verify0/verify1 own alternate seqs,
    each with its own tcache; dedup fans in both shard links. The sink
    boots under the sandbox's hardening."""
    cfg = {
        "topology": {"name": _name("sh"), "wksp_size": 1 << 24},
        "link": [{"name": n, "depth": 64}
                 for n in ("ingest", "vd0", "vd1", "dedup_sink")],
        "tcache": [{"name": "tc0", "depth": 8}, {"name": "tc1", "depth": 8},
                   {"name": "dedup_tc", "depth": 4096}],
        "tile": [
            {"name": "synth", "kind": "synth", "outs": ["ingest"],
             "count": N_SENT, "unique": N_UNIQUE, "seed": 5},
            {"name": "verify", "kind": "verify", "ins": ["ingest"],
             "outs": ["vd0", "vd1"], "tile_cnt": 2,
             "tcache": ["tc0", "tc1"], "batch": BATCH, "device": "cpu"},
            {"name": "dedup", "kind": "dedup", "ins": ["vd0", "vd1"],
             "outs": ["dedup_sink"], "tcache": "dedup_tc"},
            {"name": "sink", "kind": "sink", "ins": ["dedup_sink"],
             "sandbox": True}],
    }
    runner = TopologyRunner(tconfig.build_topology(cfg).build())
    try:
        runner.start().wait_running(timeout_s=WAIT_S)
        runner.wait_idle("sink", "rx", N_UNIQUE, timeout_s=WAIT_S)
        _wait(lambda: runner.metrics("verify0")["rx"]
              + runner.metrics("verify1")["rx"] == N_SENT, WAIT_S, runner,
              "both shards")
        got = [p for p, _ in _ring_frames(
            trt, runner.wksp, runner.plan["links"]["dedup_sink"])]
        assert sorted(got) == sorted(tsynth.make_signed_txns(N_UNIQUE,
                                                             seed=5))
        assert runner.metrics("verify0")["rx"] > 0
        assert runner.metrics("verify1")["rx"] > 0
        assert runner.metrics("sink")["rx"] == N_UNIQUE
    finally:
        runner.halt()
        runner.close()


def test_run_on_cuda_without_a_card_fails_the_boot(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the verify tile would boot on it")
    small = tmp_path / "small.toml"
    small.write_text('[[tile]]\nname = "synth"\ncount = 32\nunique = 4\n')
    rc = trun.main([TOML, str(small), "--device", "cuda",
                    "--name", _name("cli"), "--boot-timeout", "120"])
    assert rc == 1
    assert "died" in capsys.readouterr().err


def test_run_on_cpu_boots_runs_and_exits_zero(tmp_path, capsys):
    """The documented command on the plain versions, under the default
    topology name cfg<pid>: every tile reaches RUN, the monitor table
    prints, and the run tears down and removes its plan file."""
    small = tmp_path / "small.toml"
    small.write_text('[[tile]]\nname = "synth"\ncount = 32\nunique = 4\n'
                     '[[tile]]\nname = "verify"\nbatch = 16\n')
    rc = trun.main([TOML, str(small), "--device", "cpu", "--duration", "1",
                    "--interval", "0.5", "--boot-timeout", "120"])
    out = capsys.readouterr().out
    assert rc == 0
    for tn in ("synth", "verify", "dedup", "sink"):
        assert tn in out
    assert not os.path.exists(f"/dev/shm/fdtt_cfg{os.getpid()}.plan.json")


# -- ring telemetry, readers, monitor and supervisor against the reference

def _ring_script(rt, name):
    """The same ring calls on one package's runtime: publish, a credit-
    gated masked publish_batch that runs out of credits, consume (with
    an overrun), gather, credits. -> (return values, counters)."""
    import numpy as np
    w = rt.Workspace(name, 1 << 20)
    try:
        r = rt.Ring.create(w, depth=8, mtu=128)
        fs = rt.Fseq(w)
        out = [r.publish(b"abc", sig=7),
               r.publish(np.arange(5, dtype=np.uint8))]
        buf = np.arange(12 * 40, dtype=np.uint8).reshape(12, 40)
        sizes = np.arange(1, 13, dtype=np.uint32) * 3
        mask = (np.arange(12) % 3 != 0).astype(np.uint8)
        out.append(r.publish_batch(buf, sizes, np.arange(12), mask,
                                   fseqs=[fs]))
        out.append(r.credits([fs]))
        rc, frag = r.consume(0)
        out.append((rc, frag.sz))
        fs.update(r.seq)
        for i in range(10):
            r.publish(bytes([i]) * (i + 1))
        rc, _ = r.consume(1)
        out.append(rc)
        n, seq, _, got_sizes, sigs, ovr = r.gather(3, 4, 128)
        out.append((n, seq, got_sizes[:n].tolist(), sigs[:n].tolist(), ovr))
        n, seq, *_ = r.gather(seq, 16, 128)
        out.append((n, seq))
        counters = {k: getattr(r, k) for k in (
            "m_pub", "m_pub_bytes", "m_backpressure", "m_consumed",
            "m_bytes", "m_overruns")}
        return out, counters
    finally:
        w.close()
        w.unlink()


def test_ring_telemetry_counters_match_reference():
    want = _ring_script(jrt, f"/fdtpu_ttring{os.getpid()}")
    got = _ring_script(trt, f"/fdtt_ttring{os.getpid()}")
    assert got == want
    assert got[1]["m_backpressure"] > 0 and got[1]["m_overruns"] > 0


def _inline(plan, tile_name):
    from firedancer_tpu_torch.disco.topo import TileCtx
    ctx = TileCtx(plan, tile_name)
    adapter = ttiles.adapter_class(plan["tiles"][tile_name]["kind"])(
        ctx, plan["tiles"][tile_name]["args"])
    return ctx, Stem(ctx, adapter)


def test_stem_telemetry_reads_the_same_through_both_readers():
    """synth -> sink through real rings and stems in this process: the
    port's readers, link table and monitor snapshot give what the
    reference's give on the same shm, and a respawned tile resumes the
    link's cumulative series (tests/test_metrics.py:260)."""
    from firedancer_tpu.disco import metrics as jm
    from firedancer_tpu.disco import monitor as jmon
    from firedancer_tpu_torch.disco import metrics as tm
    from firedancer_tpu_torch.disco import monitor as tmon
    topo = (Topology(_name("lm"), wksp_size=1 << 22)
            .link("a_b", depth=64, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=96, unique=8, burst=8)
            .tile("b", "sink", ins=["a_b"]))
    plan = topo.build()
    w = trt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                      create=False)
    try:
        (ctx_a, stem_a), (ctx_b, stem_b) = _inline(plan, "a"), \
            _inline(plan, "b")
        for _ in range(6):             # credit-gated: alternate
            stem_a.run(max_iters=40)
            stem_b.run(max_iters=40)
        ctx_a.close()
        ctx_b.close()
        links = tm.read_link_metrics(w, plan)
        assert links == jm.read_link_metrics(w, plan)
        rec = links["a_b"]
        cons = rec["consumers"]["b"]
        assert rec["producer"] == "a" and rec["pub"] == 96
        assert cons["consumed"] == 96 and cons["overruns"] == 0
        assert cons["bytes"] == rec["pub_bytes"] > 0
        assert 0 < cons["hist"]["count"] == sum(cons["hist"]["buckets"])
        assert tmon.links_table(links) == jmon.links_table(links)
        assert tmon.format_links(tmon.links_table(links)) == \
            jmon.format_links(jmon.links_table(links))
        for tn in ("a", "b"):
            assert tm.read_hists(w, plan, tn) == jm.read_hists(w, plan, tn)
        want = jmon.snapshot(plan, w)
        got = tmon.snapshot(plan, w)
        for tn in ("a", "b"):
            for key in ("kind", "state", "metrics", "latency"):
                assert got[tn][key] == want[tn][key], (tn, key)
        assert got["b"]["metrics"]["rx"] == 96
        # a respawned tile seeds its counters from shm
        (ctx_a, stem_a), (ctx_b, stem_b) = _inline(plan, "a"), \
            _inline(plan, "b")
        assert ctx_b.in_rings["a_b"].m_consumed == 96
        assert ctx_a.out_rings["a_b"].m_pub == 96
        stem_a._flush_metrics()
        stem_b._flush_metrics()
        assert tm.read_link_metrics(w, plan) == links
        ctx_a.close()
        ctx_b.close()
    finally:
        w.close()
        trt.Workspace.unlink_name(plan["wksp"]["name"])


class _FakeProc:
    """proc-like for the Supervisor (is_alive, exitcode, terminate, kill,
    join)."""

    def __init__(self):
        self.alive, self.exitcode = True, None

    def is_alive(self):
        return self.alive

    def die(self, code):
        self.alive, self.exitcode = False, code

    def terminate(self):
        self.die(-15)

    kill = terminate

    def join(self, timeout=None):
        pass


def _supervise(T, rt, sup_mod, tag, policy, script):
    """Drive one package's Supervisor over a synth -> sink plan with fake
    processes and a fake clock. script: (t, action) with action in
    (None, "die a", "die b", "wedge b"). -> per-step (events, sink's
    supervisor counters, sink's cnc state, sink fseq stale), spawns and
    halts."""
    plan = (T(_name(tag), wksp_size=1 << 20).link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4)
            .tile("b", "sink", ins=["a_b"], supervise=policy)).build()
    w = rt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                     create=False)
    try:
        procs = {"a": _FakeProc(), "b": _FakeProc()}
        spawns, halts, now = [], [], [0.0]

        def spawn(tn, rejoin=False):
            spawns.append((tn, rejoin))
            procs[tn] = _FakeProc()
        sup = sup_mod.Supervisor(plan, w, procs=lambda: procs, spawn=spawn,
                                 halt_all=lambda: halts.append(now[0]),
                                 clock=lambda: now[0])
        cnc_b = rt.Cnc(w, off=plan["tiles"]["b"]["cnc_off"])
        fseq_b = rt.Fseq(w, off=plan["fseqs"]["a_b:b"])
        steps = []
        for t, action in script:
            now[0] = t
            if action in ("die a", "die b"):
                procs[action[-1]].die(1)
            elif action == "wedge b":
                cnc_b.state = rt.CNC_RUN        # never heartbeated
            try:
                ev = [e.split(":")[0] + (":" if ":" in e else "")
                      for e in sup.poll()]
            except RuntimeError as e:     # CircuitOpen is one too
                ev = [type(e).__name__]
            steps.append((t, ev, sup.counters("b"), cnc_b.state,
                          fseq_b.query() == rt.FSEQ_STALE))
        return steps, spawns, halts
    finally:
        w.close()
        rt.Workspace.unlink_name(plan["wksp"]["name"])


@pytest.mark.parametrize("policy,script", [
    ({"policy": "restart", "backoff_s": 0.1, "max_restarts": 2},
     [(0.0, "die b"), (0.05, None), (0.2, None), (0.3, "die b"),
      (0.6, None), (0.7, "die b"), (1.2, None)]),
    ({"policy": "restart", "wedge_timeout_s": 0.5},
     [(0.0, "wedge b"), (0.01, None), (0.1, None), (0.2, None)]),
    (None, [(0.0, None), (0.1, "die a")]),
], ids=["crash_loop_opens_breaker", "watchdog_restart", "fail_fast"])
def test_supervisor_matches_reference(policy, script):
    from firedancer_tpu.disco import supervise as jsup
    from firedancer_tpu_torch.disco import supervise as tsup
    want = _supervise(RefTopology, jrt, jsup, "sj", policy, script)
    got = _supervise(Topology, trt, tsup, "st", policy, script)
    assert got == want
    assert any(ev for _, ev, *_ in got[0])
