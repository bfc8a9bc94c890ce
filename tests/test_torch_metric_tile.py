"""The port's metric tile (firedancer_tpu_torch/disco/tiles.py
MetricAdapter, disco/metrics.py's renderer, disco/httpd.py) against the
JAX package's: render_prometheus gives the same bytes for the same plan
and shm values (tests/test_metrics.py:383-420); the tile's /metrics,
/summary.json and /healthz answer as the reference's adapter does over
the same shm (:693-825), in process and from a spawned topology; an SLO
breach rings the doorbell of each [prof] breach_capture tile; and a
breach trips the sock door through `_shed_slo_poll`."""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.disco import metrics as rmetrics
from firedancer_tpu.disco import tiles as rtiles
from firedancer_tpu.disco import topo as rtopo
from firedancer_tpu.disco.topo import TileCtx as RefTileCtx
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco import metrics as tmetrics
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.disco import topo as ttopo
from firedancer_tpu_torch.disco.metrics import (HIST_REGION_U64, HIST_U64,
                                                LINK_CONS_U64,
                                                LINK_PROD_U64)
from firedancer_tpu_torch.disco.stem import Stem
from firedancer_tpu_torch.disco.topo import TileCtx
from firedancer_tpu_torch.prof import region_for
from firedancer_tpu_torch.runtime import Workspace
from test_metrics import parse_prometheus

NOW = 10**12


def _topology(tag, **kw):
    return (Topology(f"tmt{tag}{os.getpid()}", wksp_size=1 << 23, **kw)
            .link("s_v", depth=64, mtu=1280)
            .link("v_k", depth=64, mtu=1280)
            .tcache("tc", depth=64)
            .tile("synth", "synth", outs=["s_v"], count=4)
            .tile("verify", "verify", ins=["s_v"], outs=["v_k"],
                  batch=16, tcache="tc", device="cpu")
            .tile('we"ird\\sink', "sink", ins=["v_k"])
            .tile("metric", "metric", port=0))


def _fill(plan, w, seed):
    """Random counters, histograms (one with a raced flush: count ahead
    of its buckets), link blocks and heartbeats in every tile's shm."""
    rng = np.random.default_rng(seed)
    for i, (tn, spec) in enumerate(plan["tiles"].items()):
        mv = w.view(spec["metrics_off"], 64 * 8).view(np.uint64)
        mv[:len(spec["metrics_names"])] = rng.integers(
            0, 1 << 40, len(spec["metrics_names"]))
        mv[60:64] = rng.integers(0, 5, 4)          # supervisor slots
        hv = w.view(spec["hist_off"], HIST_REGION_U64 * 8) \
            .view(np.uint64)
        for k in range(3):
            h = hv[k * HIST_U64:(k + 1) * HIST_U64]
            if k == 2 and tn != "verify":
                continue                           # no tpu series
            b = rng.integers(0, 50, HIST_U64 - 2)
            h[2:] = b
            h[1] = int(rng.integers(0, 1 << 40))
            h[0] = int(b.sum()) + (3 if i == 0 else 0)
        for off in spec["link_metrics"].values():
            lv = w.view(off, LINK_CONS_U64 * 8).view(np.uint64)
            lv[:] = rng.integers(0, 1000, LINK_CONS_U64)
            lv[3] = int(lv[5:].sum())
    for li in plan["links"].values():
        lv = w.view(li["prod_metrics_off"], LINK_PROD_U64 * 8) \
            .view(np.uint64)
        lv[:] = rng.integers(0, 5000, LINK_PROD_U64)


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(ttopo, "now_ticks", lambda: NOW)
    monkeypatch.setattr(rtopo, "now_ticks", lambda: NOW)


@pytest.mark.parametrize("seed", range(3))
def test_render_prometheus_is_byte_equal_to_reference(seed, frozen_clock):
    """One port-built plan, random values in its shm: the port's and
    the reference's renderers give the same text, which the reference's
    strict parser accepts (escaped labels, the raced flush clamped, the
    verify tile's DEVICE_SERIES promoted)."""
    plan = _topology(f"r{seed}").build()
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    rw = jrt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                       create=False)
    try:
        _fill(plan, w, seed)
        for tn, spec in plan["tiles"].items():
            jrt.Cnc(rw, off=spec["cnc_off"]).state = \
                jrt.CNC_RUN if seed % 2 else jrt.CNC_BOOT
        got = tmetrics.render_prometheus(plan, w)
        assert got == rmetrics.render_prometheus(plan, rw)
        types, samples = parse_prometheus(got)
        assert types["fdtpu_tile_tpu_jit_compiles"] == "gauge"
        assert types["fdtpu_link_consume_seconds"] == "histogram"
        assert {labels["tile"] for _, labels, _ in samples
                if "tile" in labels} == set(plan["tiles"])
    finally:
        rw.close()
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])


def test_plan_slot_abi_matches_reference():
    """The same topology built by both packages names the same metric
    slots, gauges and device series for every tile."""
    from firedancer_tpu.disco import Topology as RefTopology
    plan = _topology("abi").build()
    ref = (RefTopology(f"tmtabr{os.getpid()}", wksp_size=1 << 23)
           .link("s_v", depth=64, mtu=1280)
           .link("v_k", depth=64, mtu=1280)
           .tcache("tc", depth=64)
           .tile("synth", "synth", outs=["s_v"], count=4)
           .tile("verify", "verify", ins=["s_v"], outs=["v_k"],
                 batch=16, tcache="tc")
           .tile('we"ird\\sink', "sink", ins=["v_k"])
           .tile("metric", "metric", port=0)).build()
    try:
        for tn in plan["tiles"]:
            for key in ("metrics_names", "metrics_gauges",
                        "metrics_device"):
                assert plan["tiles"][tn][key] == ref["tiles"][tn][key], \
                    (tn, key)
    finally:
        Workspace.unlink_name(plan["wksp"]["name"])
        jrt.Workspace.unlink_name(ref["wksp"]["name"])


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_routes_match_the_reference_adapter(frozen_clock):
    """Both packages' metric adapters over one workspace: /metrics,
    /summary.json and /healthz (a tile not RUN: 503 with per-tile
    detail; all RUN with fresh heartbeats: 200), a 404, and the scrape
    and request counters."""
    plan = _topology("routes", slo={"target": [
        {"name": "lat", "expr": "verify.work p99 < 500us"}]}).build()
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                  create=False)
    rw = jrt.Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                       create=False)
    ctx, rctx = TileCtx(plan, "metric"), RefTileCtx(plan, "metric")
    port = ttiles.MetricAdapter(ctx, {"port": 0})
    ref = rtiles.MetricAdapter(rctx, {"port": 0})
    try:
        _fill(plan, w, 11)
        cncs = [jrt.Cnc(rw, off=s["cnc_off"])
                for s in plan["tiles"].values()]
        for c in cncs:
            c.state = jrt.CNC_RUN
            rw_ticks = NOW - 10
            jrt.lib.fdtpu_cnc_heartbeat(rw.base, c.off, rw_ticks)
        cncs[0].state = jrt.CNC_BOOT
        for path in ("/metrics", "/", "/healthz", "/summary.json",
                     "/nosuch", "/metrics?x=1"):
            got, want = _get(port.port, path), _get(ref.port, path)
            assert got[0] == want[0], path
            if path == "/summary.json":
                g, r = json.loads(got[1]), json.loads(want[1])
                assert g.keys() == r.keys() >= {"slo", "slo_history",
                                                "catchup", "slo_events"}
                for k in ("topology", "links", "slo", "slo_history",
                          "catchup", "slo_events"):
                    assert g[k] == r[k], k
                assert g["tiles"] == r["tiles"]
            elif path != "/nosuch":
                assert got[1] == want[1], path
        assert _get(port.port, "/healthz")[0] == 503
        cncs[0].state = jrt.CNC_RUN
        status, body = _get(port.port, "/healthz")
        assert status == 200 and json.loads(body)["ok"]
        assert port.metrics_items()["scrapes"] == \
            ref.metrics_items()["scrapes"] == 3
        assert port.metrics_items()["requests"] == 8
        assert port.metrics_items()["port"] == port.port > 0
    finally:
        port.on_halt()
        ref.on_halt()
        ctx.close()
        rctx.close()
        rw.close()
        w.close()
        Workspace.unlink_name(plan["wksp"]["name"])


def test_breach_rings_breach_capture_doorbells_and_trips_the_door():
    """An objective that cannot hold ("sink.rx > 10**9") under a fake
    clock: after the fast window is covered the port's engine breaches
    at the same pass as the reference adapter's, each rings the verify
    tile's capture doorbell (its [prof] breach_capture) on its own
    workspace, the stem flushes slo_breach, and a sock tile's
    `_shed_slo_poll` trips its door into overload."""
    from firedancer_tpu_torch.disco.shed import PeerGate, normalize_shed
    slo = {"fast_window_s": 0.3, "slow_window_s": 1.0, "target": [
        {"name": "never", "expr": "sink.rx > 1000000000"}]}
    prof = {"enable": True, "tiles": ["verify"],
            "breach_capture": ["verify"]}
    plans = []
    for tag in ("p", "r"):
        topo = (Topology(f"tmtb{tag}{os.getpid()}", wksp_size=1 << 22,
                         slo=slo, prof=prof)
                .link("s_v", depth=16, mtu=1280)
                .link("v_k", depth=16, mtu=1280)
                .link("sock_out", depth=16, external=True)
                .tcache("tc", depth=64)
                .tile("sock", "sock", outs=["sock_out"])
                .tile("synth", "synth", outs=["s_v"], count=4)
                .tile("verify", "verify", ins=["s_v"], outs=["v_k"],
                      batch=16, tcache="tc", device="cpu")
                .tile("sink", "sink", ins=["v_k"])
                .tile("metric", "metric", port=0))
        plans.append(topo.build())
    ctxs = [TileCtx(plans[0], "metric"), RefTileCtx(plans[1], "metric")]
    adapters = [ttiles.MetricAdapter(ctxs[0], {}),
                rtiles.MetricAdapter(ctxs[1], {})]
    clock = [0.0]
    for a in adapters:
        a.engine.clock = lambda: clock[0]
    stem = Stem(ctxs[0], adapters[0])
    sock_ctx = TileCtx(plans[0], "sock")
    gate = PeerGate(normalize_shed({"overload_hold_s": 5.0}))
    try:
        regions = [region_for(p, c.wksp, "verify")
                   for p, c in zip(plans, ctxs)]
        breach_at = []
        for i in range(8):
            for a in adapters:
                a.housekeeping()
            breach_at.append([a.engine.breached for a in adapters])
            clock[0] += 0.1
            stem._flush_metrics()
            ttiles._shed_slo_poll(sock_ctx, gate)
            if not adapters[0].engine.breached:
                assert regions[0].capture_req == 0
                assert not gate.overloaded()
        assert all(p == r for p, r in breach_at)
        assert breach_at[-1] == [1, 1]
        assert [r.capture_req for r in regions] == [1, 1]
        assert [r.capture_ack for r in regions] == [0, 0]
        m = [a.metrics_items() for a in adapters]
        for k in ("slo_breach", "slo_breaches", "slo_evals"):
            assert m[0][k] == m[1][k], k
        assert gate.overloaded()
        assert adapters[0].engine.history[0]["kind"] == "breach"
    finally:
        for a in adapters:
            a.on_halt()
        for c in ctxs + [sock_ctx]:
            c.close()
        for p in plans:
            Workspace.unlink_name(p["wksp"]["name"])
            from firedancer_tpu_torch.disco.slo import slo_dump_path
            path = slo_dump_path(p["topology"], "never")
            if os.path.exists(path):
                os.unlink(path)


def test_spawned_metric_tile_serves_a_live_topology():
    """synth -> sink with a metric tile, each a spawned tile process on
    the CPU: /metrics parses and names every tile and link with the
    frames that crossed, /summary.json holds the SLO engine's state and
    evals advance, /healthz is 200, and the monitor's full snapshot
    carries the (empty) breach list."""
    n = 32
    topo = (Topology(f"tmtlive{os.getpid()}", wksp_size=1 << 22,
                     slo={"fast_window_s": 0.5, "target": [
                         {"name": "flow", "expr": "sink.rx >= 0"}]})
            .link("s_k", depth=64, mtu=1280)
            .tile("synth", "synth", outs=["s_k"], count=n, unique=8,
                  seed=9)
            .tile("sink", "sink", ins=["s_k"])
            .tile("metric", "metric", port=0))
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=120)
        runner.wait_idle("sink", "rx", n, timeout_s=120)
        runner.wait_idle("metric", "slo_evals", 2, timeout_s=60)
        port = runner.metrics("metric")["port"]
        status, body = _get(port, "/metrics")
        assert status == 200
        types, samples = parse_prometheus(body.decode())
        assert {lb["tile"] for _, lb, _ in samples if "tile" in lb} == \
            {"synth", "sink", "metric"}
        pubs = {lb["link"]: v for name, lb, v in samples
                if name == "fdtpu_link_pub"}
        assert pubs == {"s_k": n}
        status, body = _get(port, "/summary.json")
        doc = json.loads(body)
        assert status == 200 and doc["slo"]["flow"]["breached"] is False
        assert doc["tiles"]["sink"]["metrics"]["rx"] == n
        assert doc["slo_events"] == [] and doc["catchup"] is None
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["ok"]
        runner.wait_idle("metric", "scrapes", 1, timeout_s=30)
    finally:
        runner.halt()
        runner.close()


def test_metric_tile_takes_no_device_and_no_build(monkeypatch):
    """app.run sets `device` on the card's tile kinds only; the metric
    tile has none, and prebuild builds nothing for a topology whose only
    tiles read shared memory or run on the host."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco import launch
    from firedancer_tpu_torch.ops import _build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    topo = build_topology(load_config(os.path.join(
        root, "firedancer_tpu_torch", "cfg", "flood.toml")), name="tmtdev")
    assert "device" not in topo.tiles["metric"].args
    assert not launch._on_card({"kind": "metric", "args": {}})
    monkeypatch.setattr(_build, "build_all", lambda *a: pytest.fail(
        "prebuild built kernels for a host-only topology"))
    launch.prebuild({"tiles": {
        "metric": {"kind": "metric", "args": {}},
        "verify": {"kind": "verify", "args": {"device": "cpu"}}}})
