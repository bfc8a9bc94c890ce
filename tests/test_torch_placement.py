"""Tile placement and housekeeping cadence in the port against the JAX
package: `cpu0` becomes each shard's `cpu_idx` in the plan as the
reference's builder and config loader make it, a spawned tile process
is pinned to that core before anything runs in it, and `lazy_ns` and
`lazy_auto` give the stem the reference's housekeeping interval for the
same out-link depths (tests/test_sandbox_tempo.py:61-100), with
utils/tempo's math equal to the reference's."""
import os
import time

import pytest

from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco import Topology as RefTopology
from firedancer_tpu.disco.stem import Stem as RefStem
from firedancer_tpu.disco.topo import TileCtx as RefTileCtx
from firedancer_tpu.runtime import Workspace as RefWorkspace
from firedancer_tpu.utils import tempo as rtempo
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco.stem import Stem
from firedancer_tpu_torch.disco.topo import TileCtx
from firedancer_tpu_torch.runtime import CNC_HALT, Workspace
from firedancer_tpu_torch.utils import tempo as ttempo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "sigverify.toml")


def _tile_args(topo):
    return {tn: {k: v for k, v in t.args.items() if k != "device"}
            for tn, t in topo.tiles.items()}


@pytest.mark.parametrize("over,pinned", [
    ({"tile": [{"name": "verify", "tile_cnt": 2, "cpu0": 1,
                "outs": ["vd0", "vd1"], "tcache": ["verify_tc", "tc1"]},
               {"name": "dedup", "ins": ["vd0", "vd1"]}],
      "link": [{"name": "vd0"}, {"name": "vd1"}],
      "tcache": [{"name": "tc1", "depth": 64}]},
     {"verify0": 1, "verify1": 2}),
    ({"tile": [{"name": "verify", "cpu0": 3}]}, {"verify": 3}),
    ({"tile": [{"name": "dedup", "cpu_idx": 5},
               {"name": "sink", "lazy_ns": 2000000},
               {"name": "synth", "lazy_auto": True}]}, {"dedup": 5}),
], ids=["sharded_cpu0", "unsharded_cpu0", "cpu_idx_lazy"])
def test_config_places_tiles_as_the_reference(over, pinned):
    """The same TOML layers through both loaders: every tile's args,
    cpu_idx included, are the reference's."""
    got = tconfig.build_topology(tconfig.load_config(TOML, overrides=over))
    want = jconfig.build_topology(jconfig.load_config(TOML, overrides=over))
    assert _tile_args(got) == _tile_args(want)
    assert {tn: a["cpu_idx"] for tn, a in _tile_args(got).items()
            if "cpu_idx" in a} == pinned


@pytest.mark.parametrize("cpu0", [None, 0, 2])
def test_sharded_tile_cpu0_matches_reference(cpu0):
    """Topology.sharded_tile(..., cpu0=) gives shard i cpu_idx = cpu0 + i
    (none without cpu0), with every other arg the reference's."""
    kw = {} if cpu0 is None else {"cpu0": cpu0}
    got = Topology("tp").sharded_tile("v", "verify", 3, ins=["a"],
                                      outs=["o0", "o1", "o2"], batch=16,
                                      **kw)
    want = RefTopology("tp").sharded_tile("v", "verify", 3, ins=["a"],
                                          outs=["o0", "o1", "o2"],
                                          batch=16, **kw)
    assert _tile_args(got) == _tile_args(want)
    want_idx = [None] * 3 if cpu0 is None else [cpu0, cpu0 + 1, cpu0 + 2]
    assert [got.tiles[f"v{i}"].args.get("cpu_idx")
            for i in range(3)] == want_idx


def test_spawned_tile_is_pinned_to_its_core():
    """A tile process with cpu_idx runs on avail[cpu_idx % len(avail)]
    of the launcher's affinity set, set before the tile booted; a tile
    without one keeps the whole set."""
    avail = sorted(os.sched_getaffinity(0))
    idx = 1 + len(avail)           # wraps: exercises the modulo
    topo = (Topology(f"tplace{os.getpid()}", wksp_size=1 << 22)
            .link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4, cpu_idx=idx)
            .tile("b", "sink", ins=["a_b"]))
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=120)
        assert os.sched_getaffinity(runner.procs["a"].pid) == \
            {avail[idx % len(avail)]}
        assert sorted(os.sched_getaffinity(runner.procs["b"].pid)) == avail
    finally:
        runner.halt()
        runner.close()


def test_tempo_math_matches_reference():
    for cr in (1, 16, 64, 1024, 8192, 1 << 20):
        for ns in (1.0, 1_000.0, 20_000.0):
            assert ttempo.lazy_default(cr, ns) == \
                rtempo.lazy_default(cr, ns)
    for lazy, n in ((1_000_000, 7), (50_000, 3), (10_000, 1), (3, 9)):
        assert ttempo.async_min(lazy, n) == rtempo.async_min(lazy, n)
    with pytest.raises(ValueError):
        ttempo.async_min(0, 1)
    assert 0.5 < ttempo.tick_per_ns(trials=3, window_s=0.001) < 2.0


class _Idle:
    def poll_once(self):
        return 0


@pytest.mark.parametrize("args", [
    {}, {"lazy_ns": 2_000_000}, {"lazy_ns": 50_000},
    {"lazy_auto": True}, {"lazy_auto": True, "lazy_ns": 0}])
@pytest.mark.parametrize("depth", [16, 1024, 8192, 1 << 16])
def test_stem_housekeeping_interval_matches_reference(args, depth):
    """The same tile args and out-link depth give the port's stem the
    reference's hk_interval_s."""
    name = f"tlazy{os.getpid()}"
    plan = (Topology(name, wksp_size=1 << 24)
            .link("a_b", depth=depth, mtu=64)
            .tile("a", "synth", outs=["a_b"], count=4, **args)
            .tile("b", "sink", ins=["a_b"])).build()
    ref = (RefTopology(name, wksp_size=1 << 24)
           .link("a_b", depth=depth, mtu=64)
           .tile("a", "synth", outs=["a_b"], count=4, **args)
           .tile("b", "sink", ins=["a_b"])).build()
    ctx, rctx = TileCtx(plan, "a"), RefTileCtx(ref, "a")
    try:
        got = Stem(ctx, _Idle()).hk_interval_s
        assert got == RefStem(rctx, _Idle()).hk_interval_s
        if args.get("lazy_ns"):
            assert got == args["lazy_ns"] * 1e-9
    finally:
        ctx.close()
        rctx.close()
        Workspace.unlink_name(plan["wksp"]["name"])
        RefWorkspace.unlink_name(ref["wksp"]["name"])


def test_lazy_ns_pins_the_housekeeping_cadence():
    """A stem with lazy_ns = 2 ms housekeeps some 500 times a second
    (the jitter spreads each interval over 0.7-1.3x)."""
    plan = (Topology(f"tcad{os.getpid()}", wksp_size=1 << 22)
            .link("a_b", depth=16, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=4, lazy_ns=2_000_000)
            .tile("b", "sink", ins=["a_b"])).build()
    ctx = TileCtx(plan, "a")

    class _Count:
        def __init__(self):
            self.hk, self.t_end = 0, time.perf_counter() + 0.5

        def poll_once(self):
            if time.perf_counter() > self.t_end:
                ctx.cnc.state = CNC_HALT
            return 0

        def housekeeping(self):
            self.hk += 1
    try:
        tile = _Count()
        Stem(ctx, tile).run()
        assert 100 < tile.hk < 400, tile.hk
    finally:
        ctx.close()
        Workspace.unlink_name(plan["wksp"]["name"])
