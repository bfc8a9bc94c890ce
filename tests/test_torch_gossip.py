"""The port's gossip tile and the front door's configuration, on the CPU:

  * three port GossipTiles converge over UDP on localhost, in process,
    each driven as its stem would (poll, then housekeeping): every node
    holds every node's contact info and published vote;
  * a tile verifying on the kernels' plain versions (device_verify,
    gossvf_bulk, device="cpu") stores the valid values of a push and
    counts the forged ones in gossvf_bad;
  * flood_crds_spam, through the gossip adapter's on_chaos, keeps the
    peer table bounded, and a staked origin's value still lands;
  * the port's GossipTile and the reference's, fed the same datagrams
    under one fake clock, end with equal metrics and CRDS stores;
  * attack_frames("flood_crds_spam") is byte-equal to the reference's;
  * tools/paced_sender: a swarm job sends at its rate, the staked pool
    equals the reference signer's txns, and the saturating sender holds
    its window;
  * cfg/flood.toml loads, and boots as four tile processes (verify on
    the CPU) that pass a staked sender's txns and drop forged ones; and
    app.run boots it; a quic tile and the flood_malformed_quic action are
    refused naming ROADMAP.md queue A item 3b.

Every address a tile can answer is on 127.0.0.1."""
import os
import socket
import time

import numpy as np
import pytest

from firedancer_tpu.disco import shed as rshed
from firedancer_tpu.tiles.gossip import GossipTile as RefGossipTile
from firedancer_tpu.utils import chaos as rchaos
from firedancer_tpu_torch.disco import shed as tshed
from firedancer_tpu_torch.flamenco import gossip_wire as gw
from firedancer_tpu_torch.gossip.crds import (KIND_NODE_INSTANCE,
                                              KIND_VOTE, CrdsValue)
from firedancer_tpu_torch.tiles.gossip import GossipTile
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.tools.gossvf_bench import make_packet
from firedancer_tpu_torch.utils import chaos as tchaos
from firedancer_tpu_torch.utils.ed25519_ref import keypair, sign

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOD_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "flood.toml")
SEEDS = [bytes([i]) * 32 for i in (1, 2, 3)]


def _vote(seed, wallclock):
    pub = keypair(seed)[2]
    return gw.encode_vote(0, pub, make_signed_txns(1, seed=9)[0], wallclock)


def _drive(tiles, done, rounds=400):
    """Poll every tile, then run its housekeeping (the stem's order),
    until done() or `rounds`; -> rounds taken."""
    for r in range(rounds):
        for t in tiles:
            t.poll_once()
        for t in tiles:
            t.housekeeping()
        if done():
            return r
        time.sleep(0.002)
    raise AssertionError(f"not done after {rounds} rounds: "
                         f"{[t.metrics for t in tiles]}")


def test_three_tiles_converge_over_udp():
    tiles = [GossipTile(SEEDS[0], device="cpu")]
    ep = [f"127.0.0.1:{tiles[0].addr[1]}"]
    tiles += [GossipTile(s, entrypoints=ep, device="cpu")
              for s in SEEDS[1:]]
    try:
        for i, t in enumerate(tiles):
            t.publish(KIND_VOTE, 0, _vote(SEEDS[i], 1000 + i))

        def done():
            return all(t.metrics["values"] >= 6
                       and t.metrics["contacts"] == 3 for t in tiles)
        _drive(tiles, done)
        pubs = {keypair(s)[2] for s in SEEDS}
        for t in tiles:
            assert {v.origin for v in t.node.crds.values.values()
                    if v.kind == KIND_VOTE} == pubs
            assert t.metrics["bad_msg"] == 0
    finally:
        for t in tiles:
            t.close()


def test_device_verify_tile_on_the_plain_versions():
    """gossvf on device="cpu" inside the tile: a push of three valid,
    one forged and one torsion value stores the valid three."""
    tile = GossipTile(SEEDS[0], device_verify=True, gossvf_bulk=True,
                      device="cpu")
    vals = make_packet(["valid", "forged", "valid", "torsion", "valid"],
                       seed=21)
    pkt = gw.encode_container(gw.MSG_PUSH, keypair(SEEDS[1])[2],
                              [v.to_wire() for v in vals])
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        tx.sendto(pkt, tile.addr)
        deadline = time.time() + 30
        while tile.metrics["rx"] < 1 and time.time() < deadline:
            tile.poll_once()
            time.sleep(0.01)
        assert tile.metrics["gossvf_bad"] == 2
        assert tile.metrics["values"] == 1 + 3     # own contact info
        stored = {v.origin for v in tile.node.crds.values.values()}
        assert {vals[i].origin for i in (0, 2, 4)} <= stored
        assert not {vals[i].origin for i in (1, 3)} & stored
    finally:
        tx.close()
        tile.close()


def test_crds_spam_frames_equal_reference():
    for n, seed in ((8, 17), (20, 3)):
        assert tchaos.attack_frames("flood_crds_spam", n, seed=seed) == \
            rchaos.attack_frames("flood_crds_spam", n, seed=seed)


def _staked_push(seed_bytes, wallclock):
    pub = keypair(seed_bytes)[2]
    data = gw.encode_node_instance(pub, wallclock, 7, 7)
    v = CrdsValue(pub, KIND_NODE_INSTANCE, 0, wallclock, data)
    v = CrdsValue(pub, KIND_NODE_INSTANCE, 0, wallclock, data,
                  sign(seed_bytes, v.signable()))
    return pub, gw.encode_container(gw.MSG_PUSH, pub, [v.to_wire()])


def test_crds_spam_through_the_adapter_keeps_peers_bounded():
    """flood_crds_spam of 512 datagrams from as many fake TEST-NET-2
    addresses (push spam: the tile never answers a push) into a tile
    with [shed] max_peers 64: the table stays bounded, and a staked
    origin's value, from a staked address, still lands."""
    from firedancer_tpu_torch.disco import Topology
    from firedancer_tpu_torch.disco.tiles import adapter_class
    from firedancer_tpu_torch.disco.topo import TileCtx
    from firedancer_tpu_torch.runtime import Workspace
    staked_seed = bytes([7]) * 32
    staked_pub, pkt = _staked_push(staked_seed, 5)
    plan = (Topology(f"tgsp{os.getpid()}", wksp_size=1 << 20,
                     shed={"rate_pps": 300.0, "burst": 8, "max_peers": 64,
                           "min_stake": 1, "overload_hold_s": 2.0,
                           "stakes": {staked_pub.hex(): 1000,
                                      "127.0.0.1:9": 1000}})
            .tile("g", "gossip", seed=SEEDS[0].hex(), device="cpu",
                  chaos={"events": [{"action": "flood_crds_spam",
                                     "frames": 512, "seed": 17}]})
            .build())
    ctx = TileCtx(plan, "g")
    try:
        a = adapter_class("gossip")(ctx, plan["tiles"]["g"]["args"])
        a.on_chaos({"action": "flood_crds_spam", "frames": 512, "seed": 17})
        a.poll_once()
        m = a.metrics_items()
        assert m["rx"] == 512 and m["bad_msg"] == 0
        assert m["peers"] <= 64 and a.tile.shed.evicted > 0
        spam_values = m["values"]
        assert spam_values > 1
        a.tile.inject(pkt, ("127.0.0.1", 9))
        a.poll_once()
        assert a.metrics_items()["values"] == spam_values + 1
        assert a.metrics_items()["peers"] <= 64
        assert a.tile.node.crds.get(staked_pub, KIND_NODE_INSTANCE) \
            is not None
        a.housekeeping()
        a.on_halt()
    finally:
        ctx.close()
        Workspace.unlink_name(plan["wksp"]["name"])


def test_gossip_tile_matches_reference(monkeypatch):
    """The same datagrams into the reference's tile and the port's, one
    fake clock for both policies: spam from Sybil addresses, overload,
    hostile bytes, a staked push, a pull request and a ping (answered to
    a local socket, whose replies must be byte-equal), a prune."""
    now = [50 * 1_000_000_000]
    for mod in (rshed, tshed):
        monkeypatch.setattr(mod, "monotonic_ns", lambda: now[0])
    staked_seed = bytes([7]) * 32
    staked_pub, staked_pkt = _staked_push(staked_seed, 5)
    shed = {"rate_pps": 100.0, "burst": 4, "max_peers": 8,
            "min_stake": 1, "overload_hold_s": 1.0,
            "stakes": {staked_pub.hex(): 500, "127.0.0.1:9": 500}}
    tiles = [cls(SEEDS[0], shed=shed) for cls in (RefGossipTile, GossipTile)]
    sinks = []
    for _ in tiles:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(2.0)
        sinks.append(s)
    try:
        requester = GossipTile(SEEDS[1])
        ci = requester.node.crds.get(requester.pubkey, 11)
        bloom = requester.node.make_pull_request(seed=3)
        keys, bits, nset = bloom.filter_fields()
        pull = gw.encode_pull_request(keys, bits, nset, (1 << 64) - 1, 0,
                                      ci.to_wire(), bits_cnt=bloom.num_bits)
        token = bytes(range(32))
        ping = gw.encode_ping(requester.pubkey, token, sign(SEEDS[1], token))
        prune_origins = [staked_pub]
        prune = gw.encode_prune(
            requester.pubkey, prune_origins,
            sign(SEEDS[1], gw.prune_signable(
                requester.pubkey, prune_origins, tiles[0].pubkey, 9)),
            tiles[0].pubkey, 9)
        requester.close()
        spam = tchaos.attack_frames("flood_crds_spam", 48, seed=5)
        script = [(b"\x07\x00\x00\x00junk", ("198.51.100.9", 1)),
                  (b"", ("198.51.100.9", 2))]
        script += [(d, (f"198.51.100.{i % 20 + 1}", 2000 + i))
                   for i, d in enumerate(spam)]
        script.append((staked_pkt, ("127.0.0.1", 9)))
        for step, (data, addr) in enumerate(script):
            now[0] += 3_000_000
            if step == 30:
                for t in tiles:
                    t.shed.trip_overload()
            for t in tiles:
                t.inject(data, addr)
        now[0] += 2_000_000_000           # the overload hold expires
        for t, s in zip(tiles, sinks):
            here = ("127.0.0.1", s.getsockname()[1])
            for data in (pull, ping, prune):
                now[0] += 3_000_000
                t.inject(data, here)
        own = (tiles[0].pubkey, 11, 0)   # each tile's contact info: its port

        def strip(views):
            return sorted(repr(v) for v in views)
        replies = []
        for s in sinks:
            got = []
            try:
                while True:
                    view = gw.parse_message(s.recv(65536))
                    if view["kind"] == "pull_response":
                        view["values"] = [
                            v for v in view["values"]
                            if (v["origin"], v["tag"], 0) != own]
                    got.append(view)
            except socket.timeout:
                pass
            replies.append(strip(got))
        assert replies[0] == replies[1] and len(replies[0]) >= 2
        m = [dict(t.metrics) for t in tiles]
        for d in m:
            d.pop("port")
        assert m[1] == m[0] and m[0]["bad_msg"] >= 2
        assert tiles[1].shed.counters() == tiles[0].shed.counters()
        stores = [sorted((k, v.hash()) for k, v in t.node.crds.values.items()
                         if k != own) for t in tiles]
        assert stores[0] == stores[1] and len(stores[0]) > 4
    finally:
        for t in tiles:
            t.close()
        for s in sinks:
            s.close()


# -- cfg/flood.toml ---------------------------------------------------------

def test_flood_toml_loads_with_the_door_policy():
    from firedancer_tpu_torch.app.config import build_topology, load_config
    cfg = load_config(FLOOD_TOML)
    topo = build_topology(cfg, name="tflood")
    assert {t.kind for t in topo.tiles.values()} == {"sock", "verify",
                                                     "dedup", "sink",
                                                     "metric"}
    assert [t["expr"] for t in topo.slo["target"]] == \
        ["sink.rx rate > 10/s"]
    assert topo.shed["max_peers"] == 64 and topo.shed["burst"] == 8
    assert topo.shed["stakes"] == {"127.0.0.1:9100": 1000}
    v = topo.tiles["verify"].args
    assert v["batch"] == 16 and v["mode"] == "bulk_prefilter"
    assert topo.links["sock_verify"].depth == 512


@pytest.mark.parametrize("what", ["quic_tile", "quic_chaos", "quic_frames"])
def test_quic_is_refused_naming_item_3b(what):
    from firedancer_tpu_torch.app.config import build_topology, load_config
    cfg = load_config(FLOOD_TOML)
    if what == "quic_tile":
        cfg["tile"][0] = dict(cfg["tile"][0], kind="quic")
        cfg["tile"][0].pop("batch")
    elif what == "quic_chaos":
        cfg["tile"][0]["chaos"] = {"events": [
            {"action": "flood_malformed_quic", "frames": 8}]}
    with pytest.raises(NotImplementedError, match="item 3b"):
        if what == "quic_frames":
            tchaos.attack_frames("flood_malformed_quic", 8)
        else:
            build_topology(cfg)


def test_flood_toml_boots_and_polices_on_the_cpu():
    """cfg/flood.toml as four tile processes, verify on the CPU: a staked
    sender's txns pass, forged frames from four unstaked sockets die in
    verify, and every tile halts cleanly. A dispatch on the plain
    versions costs about a second whatever its lanes, so the verify tile
    coalesces its gathers, and the door's buckets are deeper than the
    file's for the burst. The CPU cannot hold the file's goodput
    objective (10 frames/s at the sink), whose breach would trip the door
    into shedding these unstaked sockets, so the metric tile judges one
    it holds (tests/test_torch_metric_tile.py has the breach)."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    staked = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    staked.bind(("127.0.0.1", 0))
    key = f"127.0.0.1:{staked.getsockname()[1]}"
    cfg = load_config(FLOOD_TOML, overrides={
        "shed": {"stakes": {key: 1000}, "burst": 64},
        "slo": {"target": [{"name": "flood-goodput",
                            "expr": "sink.rx >= 0"}]},
        "tile": [{"name": "verify", "device": "cpu",
                  "coalesce_us": 300000}]})
    runner = TopologyRunner(build_topology(
        cfg, name=f"tfl{os.getpid()}").build())
    sybils = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
              for _ in range(4)]
    n = 16
    txns = make_signed_txns(n, seed=13)
    forged = tchaos.attack_frames("flood_forged", n, seed=29)
    try:
        runner.start()
        runner.wait_running(timeout_s=240)
        port = runner.metrics("sock")["port"]
        # the staked txns, then the forged frames: a saturated chunk that
        # mixes them in both halves is shed whole by the prefilter (the
        # reference's rule), which this test does not exercise
        for i in range(n):
            staked.sendto(txns[i], ("127.0.0.1", port))
        runner.wait_idle("verify", "rx", n, timeout_s=60, poll_s=0.01)
        for i in range(n):
            sybils[i % 4].sendto(forged[i], ("127.0.0.1", port))
        runner.wait_idle("verify", "rx", 2 * n, timeout_s=120, poll_s=0.01)
        runner.wait_idle("sink", "rx", n, timeout_s=180, poll_s=0.01)
        deadline = time.time() + 120
        while True:           # every forged frame decided
            v = runner.metrics("verify")
            if v["verify_fail"] + v["dedup_drop"] >= n:
                break
            assert time.time() < deadline, v
            time.sleep(0.05)
        s, v = runner.metrics("sock"), runner.metrics("verify")
        assert s["rx"] == 2 * n and s["peers"] == 5 and s["shed"] == 0
        assert runner.metrics("dedup")["rx"] == n
        assert v["cpu_fallback"] == 0 and v["device_errors"] == 0
        assert v["tx"] == n and v["rx"] == 2 * n
        # verify_fail counts the lanes the prefilter shed (rlc_shed) too
        assert v["verify_fail"] + v["dedup_drop"] == n
        m = runner.metrics("metric")
        assert m["slo_evals"] > 0 and m["slo_breaches"] == 0
        runner.halt()
        assert all(p.exitcode == 0 for p in runner.procs.values())
    finally:
        runner.halt()
        runner.close()
        for s in [staked, *sybils]:
            s.close()


def test_paced_sender_paces_round_robin():
    from firedancer_tpu_torch.tools.paced_sender import PacedSender
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(1.0)
    try:
        p = PacedSender([b"a", b"b", b"c"], rx.getsockname()[1], 200.0,
                        nsocks=2).start()
        time.sleep(0.25)
        sent = p.stop()
        assert 20 <= sent <= 80
        got = [rx.recvfrom(16) for _ in range(sent)]
        assert [d for d, _ in got[:4]] == [b"a", b"b", b"c", b"a"]
        assert len({a for _, a in got}) == 2
    finally:
        rx.close()


def test_swarm_sends_for_its_time_at_its_rate():
    """tools/paced_sender.swarm, a worker process's job: a PacedSender
    over `nsocks` sockets for `seconds` -> (sent, seconds)."""
    from firedancer_tpu_torch.tools.paced_sender import swarm
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(1.0)
    try:
        sent, sec = swarm([b"x", b"y"], rx.getsockname()[1], 400.0, 3, 0.25)
        assert 0.25 <= sec < 0.5 and 60 <= sent <= 200
        got = [rx.recvfrom(16) for _ in range(sent)]
        assert {d for d, _ in got} == {b"x", b"y"}
        assert len({a for _, a in got}) == 3
    finally:
        rx.close()


def test_staked_pool_equals_the_reference_signer():
    """tools/paced_sender.staked_pool (fixed-base table) signs the same
    bytes as the reference's make_signed_txns with its pure-Python
    RFC 8032 signer."""
    from firedancer_tpu.tiles.synth import make_signed_txns as ref_txns
    from firedancer_tpu_torch.tools.paced_sender import staked_pool
    assert staked_pool(4, 23) == ref_txns(4, seed=23)


def test_window_sender_holds_its_window():
    """WindowSender keeps at most `window` frames past what the reader
    counted, sends the pool in order, and says when it ran dry."""
    from firedancer_tpu_torch.tools.paced_sender import WindowSender
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(1.0)
    frames = [b"%d" % i for i in range(40)]
    got = []
    try:
        w = WindowSender(frames, rx.getsockname()[1], lambda: len(got),
                         8).start()
        time.sleep(0.1)
        assert w.sent == 8 and not w.dry
        while len(got) < len(frames):
            got.append(rx.recvfrom(16)[0])
            assert w.sent - len(got) <= 8
        deadline = time.time() + 5
        while not w.dry and time.time() < deadline:
            time.sleep(0.01)
        assert w.dry and w.stop() == len(frames)
        assert got == frames
    finally:
        rx.close()


def test_app_run_boots_flood_toml_on_the_cpu():
    from firedancer_tpu_torch.app import run
    assert run.main([FLOOD_TOML, "--device", "cpu", "--duration", "1",
                     "--name", f"tfr{os.getpid()}",
                     "--boot-timeout", "240"]) == 0


@pytest.mark.parametrize("seed", range(3))
def test_mutated_datagrams_never_leave_inject(seed):
    """Seeded truncations and byte flips of every message kind into the
    reference's tile and the port's (answers go to a local socket):
    nothing raises out of the port's narrowed catch, and both tiles end
    with equal metrics and stores. A PruneMessage whose origin count
    runs past the datagram goes to the port only (the reference builds
    that many slices first). Each tile's own ContactInfo names its
    socket's ephemeral port, so its hash differed between the two tiles,
    and a mutated PullRequest's bloom could hold one tile's hash and not
    the other's: one tile answered with one datagram more (tx 52 against
    51 at inject 62 of seed 0, in 9 of 108 runs here). So the
    harness republishes both tiles' ContactInfo at one address before
    the first inject, and drains the socket the answers go to."""
    from test_torch_gossip_wire import _messages, _prune_count_overruns
    rng = np.random.default_rng(seed)
    msgs = list(_messages(gw).values())
    tiles = [RefGossipTile(SEEDS[0]), GossipTile(SEEDS[0])]
    for t in tiles:
        t.node.now_ms = 1                  # strictly newer than boot's
        t.node.publish_contact_info(("127.0.0.1", 8001))
        t.node.now_ms = 0
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.setblocking(False)
    here = ("127.0.0.1", sink.getsockname()[1])

    def drain():
        while True:
            try:
                sink.recv(65536)
            except BlockingIOError:
                return
    try:
        port_only = 0
        for _ in range(200):
            data = bytearray(msgs[int(rng.integers(len(msgs)))])
            if rng.random() < 0.4:
                data = data[:int(rng.integers(len(data)))]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    data[int(rng.integers(len(data)))] = \
                        int(rng.integers(256))
            data = bytes(data)
            if _prune_count_overruns(data):
                tiles[1].inject(data, here)
                drain()
                port_only += 1
                continue
            for t in tiles:
                t.inject(data, here)
                drain()
        m = [dict(t.metrics) for t in tiles]
        for d in m:
            d.pop("port")
        m[0]["rx"] += port_only
        m[0]["bad_msg"] += port_only
        assert m[1] == m[0] and m[1]["bad_msg"] > 0
        own = (tiles[0].pubkey, 11, 0)
        stores = [sorted(k for k in t.node.crds.values if k != own)
                  for t in tiles]
        assert stores[0] == stores[1]
    finally:
        for t in tiles:
            t.close()
        sink.close()
