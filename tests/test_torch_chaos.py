"""The port's chaos harness and the verify tile's fault handling against
the JAX package's: ChaosPlan's firing points, the stem's fault actions,
`fail_dispatch` absorbed by the retries, a persistent dispatch failure
(the reference's VerifyTile on JAX's CPU backend, as tests/test_chaos.py
runs it, degrades with device_fail_limit=3; the port's on the plain
versions raises, since it has no CPU path on the card's behalf), a lost
readback and a missed verdict deadline raising, a failing warmup raising,
`device_fail_limit` refused by design, the synth's flood_forged frames,
the replay's diverge_block verdict, the refusal of actions whose kind is
not ported, and the sink crash drill of cfg/chaos.toml as four processes
(one restart, a black-box dump holding the crash then the death)."""
import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from firedancer_tpu import runtime as jrt
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.tiles import replay as jreplay
from firedancer_tpu.tiles.verify import VerifyTile as RefVerifyTile
from firedancer_tpu.utils import chaos as jchaos
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch import trace as ttrace
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.disco.unported import UNPORTED_CHAOS_ACTIONS
from firedancer_tpu_torch.tiles import replay as treplay
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.tiles.verify import VerifyTile
from firedancer_tpu_torch.trace import events as tev
from firedancer_tpu_torch.utils import chaos as tchaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "chaos.toml")
SIGVERIFY_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg",
                              "sigverify.toml")
BATCH = 16
SEED = bytes(range(16))
PERSISTENT = {"events": [{"action": "fail_dispatch", "count": -1}]}

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain verify runs in this process: one thread, as a tile on
    the CPU runs (disco/launch.py), not a pool fighting other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the fault plan ---------------------------------------------------------

SPECS = [
    {"events": [{"action": "crash", "at_iter": 5},
                {"action": "freeze_hb", "at_rx": 3}]},
    {"seed": 42, "events": [{"action": "crash", "at_iter": [100, 10000]},
                            {"action": "wedge", "at_rx": [3, 9]},
                            {"action": "stall_fseq", "at_rx": 4,
                             "link": "a_b"}]},
    {"seed": 7, "events": [{"action": "flood_forged", "at_iter": 10,
                            "frames": 32},
                           {"action": "flood_dup", "at_iter": [1, 50]},
                           {"action": "diverge_block", "at_rx": 3},
                           {"action": "crash", "at_rx": 8, "code": 9},
                           {"action": "fail_dispatch", "count": 2}]},
    {"seed": 3, "rearm": True,
     "events": [{"action": "fail_dispatch", "count": 1},
                {"action": "fail_dispatch", "count": -1},
                {"action": "flood_torsion"}]},
]


def _firing(mod, spec):
    plan = mod.ChaosPlan(spec)
    parsed = [dict(e) for e in plan.events]
    fired = [(i, r, [e["action"] for e in plan.poll(i, r)])
             for i, r in ((0, 0), (1, 0), (5, 2), (6, 3), (60, 8),
                          (10_000, 20), (10_001, 21))]
    return parsed, fired, [plan.take_dispatch_failure() for _ in range(5)]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_plan_fires_as_the_reference(spec):
    assert _firing(tchaos, spec) == _firing(jchaos, spec)


def test_chaos_plan_rejects_as_the_reference():
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError, match="unknown chaos action"):
            mod.ChaosPlan({"events": [{"action": "meteor"}]})
        with pytest.raises(ValueError, match="dict"):
            mod.ChaosPlan([1, 2])
    assert tchaos.STEM_ACTIONS == jchaos.STEM_ACTIONS
    assert tchaos.SNAPSHOT_ACTIONS == jchaos.SNAPSHOT_ACTIONS
    assert issubclass(tchaos.ChaosDeviceError, RuntimeError)


# the snapshot drills queue A item 5f ported: refused before it,
# accepted since on the tiles that take them (snapld; the replay's
# writer takes crash_mid_snapshot too)
PORTED_5F_ACTIONS = ("corrupt_checkpt_frame", "crash_mid_snapshot",
                     "stale_snapshot_offer")
# the QUIC door's flood, refused until queue A item 3b, accepted since on
# the quic tile that takes it
PORTED_3B_ACTIONS = ("flood_malformed_quic",)


@pytest.mark.parametrize("action", sorted(UNPORTED_CHAOS_ACTIONS)
                         + list(PORTED_5F_ACTIONS) + list(PORTED_3B_ACTIONS))
def test_unported_chaos_action_is_refused_with_its_item(action):
    """Refused when the topology is built, from code, from the config
    gate and on one shard of a sharded tile; a snapshot drill is
    accepted on snapld from code and through the config gate, and the
    QUIC flood on a quic tile."""
    if action in PORTED_3B_ACTIONS:
        from firedancer_tpu_torch.app import config as tconfig
        from firedancer_tpu_torch.disco import Topology
        plan = {"events": [{"action": action, "frames": 64, "at_rx": 9}]}
        assert action not in UNPORTED_CHAOS_ACTIONS
        assert Topology("tc").tile("q", "quic", chaos=plan) \
            .tiles["q"].args["chaos"] == plan
        topo = tconfig.build_topology({"tile": [
            {"name": "q", "kind": "quic", "chaos": plan}]})
        assert topo.tiles["q"].args["chaos"] == plan
        ev = tchaos.ChaosPlan(plan).events[0]
        assert (ev["action"], ev["frames"], ev["at_rx"]) == (action, 64, 9)
        return
    from firedancer_tpu_torch.app import config as tconfig
    from firedancer_tpu_torch.disco import Topology
    plan = {"events": [{"action": "crash", "at_rx": 9},
                       {"action": action}]}
    if action in PORTED_5F_ACTIONS:
        assert action not in UNPORTED_CHAOS_ACTIONS
        assert Topology("tc").tile("a", "snapld", chaos=plan) \
            .tiles["a"].args["chaos"] == plan
        topo = tconfig.build_topology({"tile": [
            {"name": "l", "kind": "snapld", "chaos": plan},
            {"name": "r", "kind": "replay", "chaos": plan}]})
        assert topo.tiles["r"].args["chaos"] == plan
        assert tchaos.ChaosPlan(plan).events[1]["action"] == action
        return
    match = f"queue A item {UNPORTED_CHAOS_ACTIONS[action]}$"
    with pytest.raises(NotImplementedError, match=match):
        Topology("tc").tile("a", "synth", chaos=plan)
    with pytest.raises(NotImplementedError, match=match):
        tconfig.build_topology({"tile": [{"name": "t", "kind": "sink",
                                          "chaos": plan}]})
    with pytest.raises(NotImplementedError, match=match):
        Topology("tc").sharded_tile("v", "verify", 2, outs=["a", "b"],
                                    chaos=[None, plan])
    # the ported actions pass, and a per-shard list lands on its shard
    topo = Topology("tc").sharded_tile(
        "v", "verify", 2, outs=["a", "b"],
        chaos=[None, {"events": [{"action": "fail_dispatch"}]}])
    assert "chaos" not in topo.tiles["v0"].args
    assert topo.tiles["v1"].args["chaos"]["events"][0]["action"] == \
        "fail_dispatch"


# -- the stem's fault actions, in this process ------------------------------

def test_stem_fires_freeze_stall_and_adapter_actions_in_order():
    """freeze_hb stops the heartbeat, stall_fseq freezes the consumer's
    fseq, a traffic action goes to the adapter's on_chaos; every one is
    an EV_CHAOS record, written before it acts."""
    from firedancer_tpu_torch.disco import Topology
    from firedancer_tpu_torch.disco.stem import Stem
    from firedancer_tpu_torch.disco.topo import TileCtx
    topo = (Topology(f"tcs{os.getpid()}", wksp_size=1 << 21,
                     trace={"enable": True, "depth": 64})
            .link("a_b", depth=32, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=8, unique=4)
            .tile("b", "sink", ins=["a_b"], chaos={"seed": 1, "events": [
                {"action": "stall_fseq", "at_rx": 4},
                {"action": "flood_dup", "at_iter": 2, "frames": 3},
                {"action": "freeze_hb", "at_iter": 6}]}))
    plan = topo.build()
    try:
        ctx = TileCtx(plan, "b")
        try:
            fired = []

            class _Tile:
                seq = 0

                def poll_once(self):
                    self.seq += 1
                    return 1

                def in_seqs(self):
                    return {"a_b": self.seq}

                def on_chaos(self, ev):
                    fired.append((ev["action"], ev["frames"]))

            stem = Stem(ctx, _Tile(), hk_interval_s=0.0, idle_sleep_s=0)
            fs = ctx.in_fseqs["a_b"]
            stem.run(max_iters=12)
            assert fired == [("flood_dup", 3)]
            assert stem._hb_frozen and stem._stalled_links == {None}
            assert fs.query() == 3     # the last update before rx 4
            evs = ttrace.read_rings(plan, ctx.wksp)["b"]
        finally:
            ctx.close()
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])
    chaos = [(e["arg"], tev.CHAOS_ACTION_NAMES[e["count"]])
             for e in evs if e["ev"] == "chaos"]
    assert chaos == [(2, "flood_dup"), (4, "stall_fseq"), (6, "freeze_hb")]


# -- the verify tile: retries, then a failure that fails the tile ----------

@pytest.fixture(scope="module")
def frames():
    """12 valid txns, then a corrupted one (signature and message, so its
    tag is its own), a duplicate, and a valid one after them."""
    txns = make_signed_txns(14, seed=7)
    bad = bytearray(txns[0])
    bad[10] ^= 1
    bad[-1] ^= 1
    return list(txns[:12]) + [bytes(bad), txns[3], txns[13]]


WAVES = (slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 15))


def _drive(rt, tile_cls, name, frames, waves=(slice(None),), trace=False,
           booted=None, catch=False, **kw):
    """Publish each wave and poll it through before the next, so each
    wave is one dispatch; `booted` is called after the tile's warmup, and
    with `catch` an exception out of the tile ends the drive and is
    returned. -> (out (payload, sig) pairs, metrics, tile, trace events,
    the exception or None)."""
    w = rt.Workspace(f"/{name}_{os.getpid()}", 1 << 24)
    try:
        in_ring = rt.Ring.create(w, depth=64, mtu=1280)
        out_ring = rt.Ring.create(w, depth=64, mtu=1280)
        tr = ttrace.TraceWriter(trt.TraceRing.create(w, 256)) \
            if trace else None
        if tr is not None:
            kw["trace"] = tr
        tile = tile_cls(in_ring, out_ring, rt.Tcache(w, depth=512),
                        batch=BATCH, dedup_seed=SEED, **kw)
        if booted is not None:
            booted()
        seq, err = 0, None
        try:
            for wave in waves:
                for f in frames[wave]:
                    in_ring.publish(f, sig=seq)
                    seq += 1
                while tile.poll_once():
                    pass
                tile.flush()
        except Exception as e:
            if not catch:
                raise
            err = e
        out, s = [], 0
        while (got := out_ring.consume(s))[0] == 0:
            out.append((bytes(out_ring.payload(got[1])), int(got[1].sig)))
            s += 1
        evs = [tev.decode(r) for r in tr.ring.snapshot()[1]] if tr else []
        return out, dict(tile.metrics), tile, evs, err
    finally:
        w.close()
        w.unlink()


def test_transient_dispatch_failure_absorbed_by_retries(frames):
    kw = {"chaos": {"events": [{"action": "fail_dispatch", "count": 2}]}}
    ref = _drive(jrt, RefVerifyTile, "fdtpu_tcr", frames, **kw)
    port = _drive(trt, VerifyTile, "fdtt_tcr", frames, device="cpu", **kw)
    assert port[0] == ref[0] and port[1] == ref[1]
    m = port[1]
    assert m["device_errors"] == 2 and m["cpu_fallback"] == 0
    assert m["tx"] == 13 and m["verify_fail"] == 1


@pytest.mark.parametrize("retries", [0, 2])
def test_persistent_dispatch_failure_raises_where_the_reference_degrades(
        frames, retries):
    """Every attempt fails. The reference's tile (device_fail_limit=3)
    verifies on the host and degrades; the port's has no CPU path on the
    card's behalf: the first wave's dispatch raises out of poll_once after
    its retries, with nothing published and cpu_fallback 0."""
    ref = _drive(jrt, RefVerifyTile, "fdtpu_tcp", frames, WAVES,
                 device_retries=retries, device_fail_limit=3,
                 chaos=PERSISTENT)
    assert ref[1]["cpu_fallback"] == 1 and ref[2].degraded
    assert [p for p, _ in ref[0]] == [f for i, f in enumerate(frames)
                                      if i not in (12, 13)]
    out, m, tile, evs, err = _drive(
        trt, VerifyTile, "fdtt_tcp", frames, WAVES, trace=True, catch=True,
        device="cpu", device_retries=retries, chaos=PERSISTENT)
    assert isinstance(err, RuntimeError)
    assert f"dispatch failed {retries + 1} times" in str(err)
    assert isinstance(err.__cause__, tchaos.ChaosDeviceError)
    assert out == [] and m["tx"] == 0 and m["batches"] == 0
    assert (m["device_errors"], m["cpu_fallback"]) == (retries + 1, 0)
    assert not hasattr(tile, "degraded")
    names = [e["ev"] for e in evs]
    assert names.count("chaos") == retries + 1   # one a failed attempt
    assert "cpu_fallback" not in names and "tpu_dispatch" not in names


def test_readback_failure_raises(frames, monkeypatch):
    """A verdict wait that fails (a sticky CUDA error surfaces there)
    leaves poll_once; the readback span still closes."""
    from firedancer_tpu_torch.tiles import verify as tverify

    def lost(self):
        raise RuntimeError("CUDA error: an illegal memory access")

    def booted():
        monkeypatch.setattr(tverify._Verdicts, "result", lost)
    out, m, _, evs, err = _drive(trt, VerifyTile, "fdtt_tcb", frames,
                                 WAVES, trace=True, booted=booted,
                                 catch=True, device="cpu")
    assert "illegal memory access" in str(err)
    assert out == [] and (m["device_errors"], m["cpu_fallback"]) == (1, 0)
    names = [e["ev"] for e in evs]
    assert names.count("tpu_dispatch") == names.count("tpu_readback") == 1


def test_verdict_deadline_raises(frames, monkeypatch):
    """device_timeout_s bounds a verdict wait, which spins on the batch's
    event (never synchronize); past the deadline the wait raises out of
    poll_once."""
    from firedancer_tpu_torch.tiles import verify as tverify

    class Stuck:                       # an event that never completes
        def query(self):
            return False

        def synchronize(self):
            raise AssertionError("the deadline wait synchronized")

    def booted():
        monkeypatch.setattr(VerifyTile, "_device_verify",
                            lambda self, bs, uploaded=False:
                            tverify._Verdicts(bs, Stuck()))
    out, m, _, evs, err = _drive(trt, VerifyTile, "fdtt_tct", frames,
                                 WAVES, trace=True, booted=booted,
                                 catch=True, device="cpu",
                                 device_timeout_s=0.05)
    assert isinstance(err, TimeoutError)
    assert "not ready after 0.05 s" in str(err)
    assert out == [] and (m["device_errors"], m["cpu_fallback"]) == (2, 0)
    assert [e["ev"] for e in evs].count("tpu_dispatch") == 1


def test_failing_warmup_raises(monkeypatch):
    """A kernel that does not build or launch fails the constructor."""
    from firedancer_tpu_torch.ops import cuda_ed

    def broken(*a, **k):
        raise RuntimeError("nvcc failed for ed25519_verify.cu")
    monkeypatch.setattr(cuda_ed, "verify_batch", broken)
    w = trt.Workspace(f"/fdtt_tcw_{os.getpid()}", 1 << 20)
    try:
        ring = trt.Ring.create(w, depth=8, mtu=1280)
        with pytest.raises(RuntimeError, match="ed25519_verify"):
            VerifyTile(ring, ring, trt.Tcache(w, depth=64), batch=BATCH,
                       device="cpu")
    finally:
        w.close()
        w.unlink()


def test_verify_adapter_passes_the_fault_args():
    from firedancer_tpu_torch.disco import Topology
    from firedancer_tpu_torch.disco.topo import TileCtx
    args = {"batch": BATCH, "device": "cpu", "device_retries": 1,
            "device_timeout_s": 5, "chaos": PERSISTENT}
    plan = (Topology(f"tca{os.getpid()}", wksp_size=1 << 24,
                     trace={"enable": True, "tiles": ["v"]})
            .link("in", depth=64).link("out", depth=64)
            .tcache("tc", depth=64)
            .tile("s", "synth", outs=["in"])
            .tile("v", "verify", ins=["in"], outs=["out"], **args)
            .tile("k", "sink", ins=["out"])).build()
    try:
        ctx = TileCtx(plan, "v")
        try:
            t = ttiles.REGISTRY["verify"](ctx, plan["tiles"]["v"]["args"]).tile
            assert (t.device_retries, t.device_timeout_s) == (1, 5.0)
            assert t._chaos.take_dispatch_failure()
            assert t._trace is ctx.trace is not None
            # link ids index the plan's sorted link names: in, out
            assert (t._trace_link, t._trace_link_in) == (1, 0)
            d = ttiles.REGISTRY["verify"](
                ctx, {"batch": BATCH, "device": "cpu"}).tile
            assert (d.device_retries, d.device_timeout_s, d._chaos) == \
                (2, None, None)
        finally:
            ctx.close()
    finally:
        trt.Workspace.unlink_name(plan["wksp"]["name"])


@pytest.mark.parametrize("route", ["tile", "sharded_tile", "config"])
def test_device_fail_limit_is_refused_by_design(route):
    """The reference's degradation knob is refused when the topology is
    built, naming ROADMAP.md C (a deliberate difference, no queue-A
    item); the constructor has no such argument."""
    from firedancer_tpu_torch.app import config as tconfig
    from firedancer_tpu_torch.disco import Topology
    with pytest.raises(NotImplementedError,
                       match="'device_fail_limit' is refused by design .*"
                             "ROADMAP.md C$"):
        if route == "tile":
            Topology("tc").tile("v", "verify", device_fail_limit=3)
        elif route == "sharded_tile":
            Topology("tc").sharded_tile("v", "verify", 2, outs=["a", "b"],
                                        device_fail_limit=1)
        else:
            tconfig.build_topology(tconfig.load_config(
                SIGVERIFY_TOML, overrides={"tile": [
                    {"name": "verify", "device_fail_limit": 3}]}))
    with pytest.raises(TypeError, match="device_fail_limit"):
        VerifyTile(None, None, None, device_fail_limit=3)


# -- the synth's flood and the replay's divergence --------------------------

def _synth(rt, tiles, w, depth=64):
    ring = rt.Ring.create(w, depth=depth, mtu=1280)
    ctx = SimpleNamespace(tile_name="synth", out_rings={"a_b": ring},
                          out_fseqs={"a_b": []})
    return tiles.REGISTRY["synth"](ctx, {"count": 0}), ring


def _ring_frames(ring):
    out, s = [], 0
    while (got := ring.consume(s))[0] == 0:
        out.append((bytes(ring.payload(got[1])), int(got[1].sig)))
        s += 1
    return out


def test_flood_forged_matches_reference_and_verify_refuses_it():
    ev = tchaos.ChaosPlan({"seed": 7, "events": [
        {"action": "flood_forged", "frames": 16}]}).events[0]
    assert ev == jchaos.ChaosPlan({"seed": 7, "events": [
        {"action": "flood_forged", "frames": 16}]}).events[0]
    got = {}
    for name, rt, tiles in (("ref", jrt, jtiles), ("port", trt, ttiles)):
        w = rt.Workspace(f"/fd{name}_tcf_{os.getpid()}", 1 << 22)
        try:
            syn, ring = _synth(rt, tiles, w)
            syn.on_chaos(ev)
            syn.on_chaos({"action": "crash"})      # not a traffic action
            got[name] = (_ring_frames(ring), syn.metrics_items())
        finally:
            w.close()
            w.unlink()
    assert got["port"] == got["ref"]
    flood, m = got["port"]
    assert len(flood) == 16 and m["attack_tx"] == 16
    out, vm, _, _, _ = _drive(trt, VerifyTile, "fdtt_tcv",
                           [f for f, _ in flood], device="cpu")
    assert out == [] and vm["tx"] == 0 and vm["verify_fail"] == 16


def test_flood_drops_newest_when_the_ring_has_no_credits():
    from firedancer_tpu_torch.runtime import Fseq
    w = trt.Workspace(f"/fdtt_tcn_{os.getpid()}", 1 << 22)
    try:
        syn, ring = _synth(trt, ttiles, w, depth=8)
        syn.fseqs = [Fseq(w)]              # a consumer that never reads
        syn.on_chaos({"action": "flood_dup", "frames": 20, "seed": 1})
        m = syn.metrics_items()
        assert m["attack_tx"] == 8 and m["attack_drop"] == 12
    finally:
        w.close()
        w.unlink()


def test_diverge_block_names_the_same_slot():
    """The replay's chaos seam through each package's adapter hook: the
    slot replayed after the event carries the rogue account, and its
    divergence verdict names it in both."""
    from test_torch_replay import GENESIS, HPT, PUB, leader_wires
    from firedancer_tpu_torch.tiles import shred as tshred
    txns = make_signed_txns(6, seed=6)
    wires = leader_wires({1: [txns[:2]], 2: [txns[2:6]]}, 4)

    class Out:
        def __init__(self):
            self.frames = []

        def publish(self, frame, sig=0):
            self.frames.append(bytes(frame))

        def credits(self, fseqs):
            return 1 << 30
    rec = Out()
    core = tshred.ShredRecoverCore(PUB, rec, None)
    for w in wires:
        core.on_shred(w)
    slices = rec.frames
    clean = treplay.ReplayCore(genesis=GENESIS, hashes_per_tick=HPT,
                               verify_poh=False, device="cpu")
    for f in slices:
        clean.on_slice(f)
    assert clean.metrics["slots_replayed"] == 4
    ev = tchaos.ChaosPlan({"seed": 5, "events": [
        {"action": "diverge_block"}]}).events[0]
    seen = []
    for mod, tiles, kw in ((jreplay, jtiles, {}),
                           (treplay, ttiles, {"device": "cpu"})):
        c = mod.ReplayCore(genesis=GENESIS, hashes_per_tick=HPT,
                           verify_poh=False,
                           expected=dict(clean.bank_hash_of), **kw)
        adapter = SimpleNamespace(core=c)
        it = iter(slices)
        while c.metrics["slots_replayed"] < 2:
            c.on_slice(next(it))
        tiles.REGISTRY["replay"].on_chaos(adapter, ev)
        tiles.REGISTRY["replay"].on_chaos(adapter, {"action": "crash"})
        with pytest.raises(RuntimeError, match="divergence at slot 2"):
            for f in it:
                c.on_slice(f)
        seen.append((c.metrics["divergent_slot"], c.bank_hash_of[2]))
    assert seen[1] == seen[0] and seen[0][0] == 2
    assert seen[0][1] != clean.bank_hash_of[2]


# -- the sink crash drill of cfg/chaos.toml ---------------------------------

def test_chaos_toml_sink_crash_restarts_once_with_a_black_box():
    """cfg/chaos.toml as four processes, verify on the CPU, 512 frames
    over its 64 unique: the sink dies at rx 32, the supervisor dumps its
    ring (the chaos record, then the death) and respawns it once without
    the plan; every unique txn passes dedup and the tiles halt cleanly.
    The sink's 1 s wedge deadline is widened: a loaded test host can stall
    a healthy process that long."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco import TopologyRunner
    name = f"tchaos{os.getpid()}"
    cfg = load_config(CHAOS_TOML, overrides={"tile": [
        {"name": "synth", "count": 512},
        {"name": "verify", "device": "cpu"},
        {"name": "sink", "supervise": {"wedge_timeout_s": 30.0}}]})
    runner = TopologyRunner(build_topology(cfg, name=name).build()).start()
    path = ttrace.blackbox_path(name, "sink")
    try:
        runner.wait_running(timeout_s=240)
        deadline = time.time() + 240
        while True:
            runner.check_failures()
            d = runner.metrics("dedup")
            s = runner.metrics("sink")
            if d["tx"] >= 64 and s["sup_restarts"] >= 1 \
                    and s["sup_down"] == 0 \
                    and runner.metrics("synth")["tx"] >= 512:
                break
            assert time.time() < deadline, (d, s)
            time.sleep(0.05)
        runner.wait_running(timeout_s=120)   # the respawned sink is up
        v = runner.metrics("verify")
        assert (v["tx"], v["verify_fail"], v["cpu_fallback"],
                v["device_errors"]) == (64, 0, 0, 0)
        assert runner.supervisor.blackbox == {"sink": path}
        with open(path) as f:
            dump = json.load(f)
        assert dump["tile"] == "sink" and dump["reason"] == "died (exit 70)"
        names = [e["ev"] for e in dump["events"]]
        assert names[-2:] == ["chaos", "down"]
        crash = next(e for e in dump["events"] if e["ev"] == "chaos")
        assert crash["count"] == tev.CHAOS_ACTION_IDS["crash"]
        time.sleep(0.3)
        runner.halt(join_timeout_s=20)
        assert {tn: p.exitcode for tn, p in runner.procs.items()} == \
            dict.fromkeys(runner.procs, 0)
        s = runner.metrics("sink")
        assert s["sup_restarts"] == 1 and s["sup_watchdog_trips"] == 0
        live = [e["ev"] for e in ttrace.read_rings(
            runner.plan, runner.wksp)["sink"]]
        i = live.index("restart")
        assert live[i + 1] == "boot" and live[-1] == "halt"
        assert "chaos" not in live[i:]          # the respawn came up clean
    finally:
        runner.halt(join_timeout_s=10)
        runner.close()
        if os.path.exists(path):
            os.unlink(path)
