"""The port's front-door policy (firedancer_tpu_torch/disco/shed.py)
against the reference's disco/shed.py: the schema, the merge of the
[shed] section with a tile's override, and PeerGate driven through the
same call sequences under a fixed clock (the token buckets, the Sybil
churn of a bounded table, the all-staked table, overload and its
expiry, drop-newest accounting). Every admit verdict, counter and peer
table must be equal. Then the cases of tests/test_shed.py on the port's
gate, config load and topology build, and PressureProbe over a built
plan. Host code only: exact."""
import os

import numpy as np
import pytest

from firedancer_tpu.disco import shed as rshed
from firedancer_tpu.disco import slo as rslo
from firedancer_tpu_torch.disco import shed as tshed

S = 1_000_000_000              # 1 s in ns (explicit now= clocks)


# -- schema -----------------------------------------------------------------

def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("err", str(e))


SPECS = [
    None, {}, {"rate_pps": 9}, {"burst": 2, "max_peers": "7"},
    {"enable": 0}, {"stakes": {"1.2.3.4:5": "40", "aa": 0}},
    {"rate_ppz": 1.0}, {"rate_pps": 0}, {"burst": 0.5}, {"max_peers": 1},
    {"min_stake": -1}, {"overload_hold_s": 0}, {"stakes": [1, 2]},
    {"stakes": {"": 5}}, {"stakes": {"1.2.3.4:5": -3}}, "nope",
    {"stakez": {}}, {"overload_hold_s": 2.5, "min_stake": 3},
]


@pytest.mark.parametrize("per_tile", [False, True])
@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_normalize_shed_matches_reference(spec, per_tile):
    assert _outcome(tshed.normalize_shed, spec, per_tile=per_tile) == \
        _outcome(rshed.normalize_shed, spec, per_tile=per_tile)


MERGES = [
    (None, None), ({"rate_pps": 100.0, "stakes": {"a:1": 5}}, None),
    ({"rate_pps": 100.0, "stakes": {"a:1": 5}},
     {"rate_pps": 7.0, "stakes": {"b:2": 9}}),
    ({"enable": False}, None), ({"rate_pps": 3.0}, {"enable": False}),
    (None, {"rate_pps": 3.0}), ({"max_peers": 8}, {"max_peerz": 9}),
]


@pytest.mark.parametrize("topo,over", MERGES, ids=range(len(MERGES)))
def test_effective_shed_matches_reference(topo, over):
    assert _outcome(tshed.effective_shed, topo, over) == \
        _outcome(rshed.effective_shed, topo, over)


def test_defaults_and_keys_match_reference():
    assert tshed.SHED_DEFAULTS == rshed.SHED_DEFAULTS
    assert tshed.TILE_SHED_KEYS == rshed.TILE_SHED_KEYS


# -- PeerGate: the same call sequences --------------------------------------

def _run(gate_cls, cfg, ops):
    """ops: ("admit", addr, now) | ("trip", now) | ("drop", addr) |
    ("over", now) -> (results, counters, peer table)."""
    g = gate_cls(cfg)
    res = []
    for op in ops:
        if op[0] == "admit":
            res.append(g.admit(op[1], op[2]))
        elif op[0] == "trip":
            g.trip_overload(op[1])
        elif op[0] == "drop":
            g.count_drop(op[1])
        else:
            res.append(g.overloaded(op[1]))
    state = {k: getattr(g, k) for k in (
        "shed_total", "shed_rate", "shed_unstaked", "shed_drop",
        "evicted", "overload_until")}
    return res, state, {k: list(v) for k, v in g.peers.items()}


def _seq_bucket():
    a, b = ("10.0.0.1", 5), ("10.0.0.2", 5)
    ops = [("admit", a, 0)] * 3 + [("admit", b, 0)]
    ops += [("admit", a, S)] * 3 + [("admit", a, 101 * S)] * 3
    return {"rate_pps": 2.0, "burst": 2, "max_peers": 16}, ops


def _seq_sybil():
    cfg = {"rate_pps": 100.0, "burst": 4, "max_peers": 4, "min_stake": 1,
           "stakes": {"10.0.0.1:1": 100, "10.0.0.2:1": 100}}
    ops = [("admit", ("10.0.0.1", 1), 0), ("admit", ("10.0.0.2", 1), 0)]
    ops += [("admit", (f"172.16.{i % 250}.{i // 250}", 9), 0)
            for i in range(1000)]
    return cfg, ops


def _seq_all_staked():
    cfg = {"rate_pps": 100.0, "burst": 4, "max_peers": 2, "min_stake": 1,
           "stakes": {"10.0.0.1:1": 50, "10.0.0.2:1": 50,
                      "10.0.0.3:1": 50}}
    ops = [("admit", ("10.0.0.1", 1), 0), ("admit", ("10.0.0.2", 1), 0),
           ("admit", ("99.9.9.9", 1), 0), ("admit", ("10.0.0.3", 1), 0)]
    return cfg, ops


def _seq_overload():
    cfg = {"rate_pps": 100.0, "burst": 8, "max_peers": 16, "min_stake": 10,
           "overload_hold_s": 1.0,
           "stakes": {"10.0.0.1:1": 50, "10.0.0.9:1": 3}}
    staked, low, unstaked = ("10.0.0.1", 1), ("10.0.0.9", 1), ("6.6.6.6", 1)
    ops = [("admit", unstaked, 0), ("trip", 0), ("over", 0),
           ("admit", unstaked, 0), ("admit", low, 0), ("admit", staked, 0)]
    ops += [("admit", (f"7.7.{i}.1", 1), 0) for i in range(100)]
    ops += [("trip", S // 2), ("over", S), ("over", S // 2 + S),
            ("admit", unstaked, S // 2 + S)]
    return cfg, ops


def _seq_drops():
    return {"stakes": {"10.0.0.1:1": 5}}, [
        ("drop", ("10.0.0.1", 1)), ("drop", ("8.8.8.8", 1)),
        ("admit", b"\xaa\xbb", 0), ("drop", b"\xaa\xbb")]


def _seq_random(seed):
    """A seeded mix over a small address space: admits at advancing
    times, overload trips, drops, origins as bytes."""
    rng = np.random.default_rng(seed)
    addrs = [(f"10.1.0.{i}", 7) for i in range(12)] + \
        [bytes([i]) * 32 for i in range(4)]
    stakes = {"10.1.0.0:7": 9, "10.1.0.3:7": 1,
              (bytes([1]) * 32).hex(): 20}
    cfg = {"rate_pps": 50.0, "burst": 3, "max_peers": 6, "min_stake": 2,
           "overload_hold_s": 0.05, "stakes": stakes}
    ops, now = [], 0
    for _ in range(600):
        now += int(rng.integers(0, 20_000_000))
        r = rng.random()
        a = addrs[int(rng.integers(len(addrs)))]
        if r < 0.8:
            ops.append(("admit", a, now))
        elif r < 0.87:
            ops.append(("trip", now))
        elif r < 0.95:
            ops.append(("drop", a))
        else:
            ops.append(("over", now))
    return cfg, ops


SEQS = {"bucket": _seq_bucket, "sybil": _seq_sybil,
        "all_staked": _seq_all_staked, "overload": _seq_overload,
        "drops": _seq_drops, "random0": lambda: _seq_random(0),
        "random1": lambda: _seq_random(1), "random2": lambda: _seq_random(2)}


@pytest.mark.parametrize("name", sorted(SEQS))
def test_peer_gate_matches_reference(name):
    cfg, ops = SEQS[name]()
    got = _run(tshed.PeerGate, cfg, ops)
    assert got == _run(rshed.PeerGate, cfg, ops)
    assert got[0], "the sequence must decide something"


# -- the cases of tests/test_shed.py on the port's gate ---------------------

def test_token_bucket_rate_limits_per_peer():
    g = tshed.PeerGate({"rate_pps": 2.0, "burst": 2, "max_peers": 16})
    a, b = ("10.0.0.1", 5), ("10.0.0.2", 5)
    assert g.admit(a, 0) and g.admit(a, 0)
    assert not g.admit(a, 0)
    assert g.admit(b, 0)
    assert g.shed_total == 1 and g.shed_rate == 1
    assert g.admit(a, S) and g.admit(a, S) and not g.admit(a, S)
    assert tshed.PeerGate.key_of(("1.2.3.4", 80)) == "1.2.3.4:80"
    assert tshed.PeerGate.key_of(b"\xaa\xbb") == "aabb"


def test_sybil_flood_churns_unstaked_slots_never_staked():
    cfg, ops = _seq_sybil()
    g = tshed.PeerGate(cfg)
    for op in ops:
        g.admit(op[1], op[2])
    assert len(g.peers) <= 4 and g.evicted > 0
    assert "10.0.0.1:1" in g.peers and "10.0.0.2:1" in g.peers


def test_overload_sheds_unstaked_and_recovers_on_expiry():
    cfg, _ = _seq_overload()
    g = tshed.PeerGate(cfg)
    assert g.admit(("6.6.6.6", 1), 0)
    g.trip_overload(0)
    assert not g.admit(("6.6.6.6", 1), 0)
    assert g.admit(("10.0.0.1", 1), 0)
    assert g.overloaded(S - 1) and not g.overloaded(S)
    assert g.admit(("6.6.6.6", 1), S)
    assert g.counters() == {"shed": 1, "shed_unstaked": 1, "peers": 2,
                            "overload": 0}


def test_gate_counts_staked_packets_read_and_shed():
    """The port's staked accounting, which the sock tile publishes as
    rx_staked and shed_staked: every packet of a peer with a stake,
    admitted, shed by its bucket or dropped at a full door, and none of
    an unstaked peer's; the counters stay the reference's."""
    from firedancer_tpu_torch.disco import tiles as ttiles
    cfg = {"rate_pps": 1.0, "burst": 2, "max_peers": 16,
           "stakes": {"10.0.0.1:5": 10}}
    gates = [rshed.PeerGate(cfg), tshed.PeerGate(cfg)]
    staked, sybil = ("10.0.0.1", 5), ("6.6.6.6", 1)
    for g in gates:
        for addr in (staked,) * 3 + (sybil,) * 3:
            g.admit(addr, 0)
        g.count_drop(staked)
        g.count_drop(sybil)
    assert (gates[1].staked_rx, gates[1].staked_shed) == (4, 2)
    assert gates[1].counters() == gates[0].counters()
    assert gates[1].shed_total == gates[0].shed_total == 4
    assert ttiles.REGISTRY["sock"].METRICS[-2:] == ["rx_staked",
                                                    "shed_staked"]


# -- the [shed] section through config load and Topology.build -------------

def _cfg(**over):
    cfg = {"topology": {"name": f"tshed{os.getpid()}",
                        "wksp_size": 1 << 22},
           "link": [{"name": "a_b", "depth": 32}],
           "tile": [{"name": "s", "kind": "sock", "outs": ["a_b"]},
                    {"name": "d", "kind": "sink", "ins": ["a_b"]}]}
    cfg.update(over)
    return cfg


def test_bad_shed_rejected_at_config_load_and_topo_build():
    from firedancer_tpu_torch.app.config import build_topology
    from firedancer_tpu_torch.disco import Topology
    with pytest.raises(ValueError, match="did you mean 'rate_pps'"):
        build_topology(_cfg(shed={"rate_ppz": 1.0}))
    topo = (Topology("bad_shed", shed={"max_peers": 1})
            .link("a_b", depth=32)
            .tile("s", "sock", outs=["a_b"])
            .tile("d", "sink", ins=["a_b"]))
    with pytest.raises(ValueError, match="max_peers"):
        topo.build()
    topo2 = (Topology("bad_shed2")
             .link("a_b", depth=32)
             .tile("s", "sock", outs=["a_b"], shed={"overload_hold_s": -1})
             .tile("d", "sink", ins=["a_b"]))
    with pytest.raises(ValueError, match="overload_hold_s"):
        topo2.build()


def test_plan_carries_shed_and_probe_matches_reference():
    """The plan's [shed] section; with no metric tile the breach reader
    and the probe's gauge read 0; the per-link backpressure delta and its
    link, against the reference's PressureProbe on the same plan."""
    from firedancer_tpu_torch.app.config import build_topology
    from firedancer_tpu_torch.disco.metrics import (LINK_PROD_COUNTERS,
                                                    LINK_PROD_U64)
    from firedancer_tpu_torch.runtime import Workspace
    plan = build_topology(_cfg(shed={"rate_pps": 11.0})).build()
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"], create=False)
    try:
        assert plan["shed"]["rate_pps"] == 11.0
        assert plan["shed"]["burst"] == tshed.SHED_DEFAULTS["burst"]
        assert tshed.slo_breach_count(plan, w) == 0
        probes = (tshed.PressureProbe(plan, w),
                  rslo.PressureProbe(plan, w))
        bp = LINK_PROD_COUNTERS.index("backpressure")
        blk = w.view(plan["links"]["a_b"]["prod_metrics_off"],
                     LINK_PROD_U64 * 8).view(np.uint64)
        seen = []
        for val in (5, 5, 12, 40):
            blk[bp] = val
            seen.append([(p.link_pressure(), p.overloaded(),
                          {k: v for k, v in p.poll().items()
                           if k != "bp_delta" and k != "worst_link"})
                         for p in probes])
        for got, want in seen:
            assert got == want
        assert [s[0][0] for s in seen] == [(0, None), (0, None),
                                           (7, "a_b"), (28, "a_b")]
    finally:
        w.close()
        w.unlink()
