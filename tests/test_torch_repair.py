"""The port's repair (repair/forest.py, repair/policy.py, tiles/repair.py
and disco/tiles.py's RepairAdapter, copies of the JAX package's) against
the reference's: the forest and policy cases of
tests/test_leaders_repair.py in lockstep (tests/torch_lockstep.py); a
hypothesis test over shred arrival orders and gaps (the same frontier
and requests after every shred, the same request bytes for one identity
and timestamp); RepairCore across UDP on loopback, the port's client
repaired by the reference's server and the reference's client by the
port's server, against both packages' own pair: the same signed request
datagrams, the same response wires byte for byte, the same metrics; and
the repair door's policing and backpressure (tests/test_flood.py:485-575)
on both packages under one frozen clock."""
import socket

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_leaders_repair
from torch_lockstep import lockstep

from firedancer_tpu.disco import shed as jshed
from firedancer_tpu.disco.tiles import RepairAdapter as JRepairAdapter
from firedancer_tpu.repair import forest as jforest
from firedancer_tpu.repair import policy as jpolicy
from firedancer_tpu.tiles import repair as jrepair
from firedancer_tpu_torch.disco import shed as tshed
from firedancer_tpu_torch.disco.tiles import RepairAdapter as TRepairAdapter
from firedancer_tpu_torch.repair import forest as tforest
from firedancer_tpu_torch.repair import policy as tpolicy
from firedancer_tpu_torch.shred import format as fmt
from firedancer_tpu_torch.shred.shredder import Shredder
from firedancer_tpu_torch.tiles import repair as trepair
from firedancer_tpu_torch.utils import ed25519_ref as ed

NAMES = {"Forest": "repair.forest.Forest",
         "RepairPolicy": "repair.policy.RepairPolicy",
         "parse_request": "repair.policy.parse_request"}
LEADER_SEED = bytes(range(32))
LEADER = ed.keypair(LEADER_SEED)[-1]
CLIENT_SEED = bytes(range(1, 33))
CLIENT = ed.keypair(CLIENT_SEED)[-1]
PKGS = {"ref": (jforest, jpolicy, jrepair), "port": (tforest, tpolicy,
                                                     trepair)}


@pytest.mark.parametrize("case", sorted(
    n for n in vars(test_leaders_repair)
    if n.startswith(("test_forest", "test_policy"))))
def test_forest_policy_cases_match_reference(case):
    rec = lockstep(getattr(test_leaders_repair, case), NAMES)
    assert any(r[0] in ("Forest", "RepairPolicy") for r in rec)


# -- arrival orders and gaps ---------------------------------------------

def _layout(draw_sizes):
    """[(slot, idx, parent_off, complete)] of slots 1..n, parent 1 or 2
    back, `size` data shreds each."""
    out = []
    for k, (size, back) in enumerate(draw_sizes):
        slot = k + 1
        for idx in range(size):
            out.append((slot, idx, min(back, slot), idx == size - 1))
    return out


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(1, 5), st.integers(1, 2)),
                min_size=1, max_size=8).flatmap(
    lambda sizes: st.tuples(
        st.just(sizes),
        st.permutations(range(sum(s for s, _ in sizes))),
        st.lists(st.booleans(), min_size=sum(s for s, _ in sizes),
                 max_size=sum(s for s, _ in sizes)),
        st.integers(0, 3))))
def test_frontier_and_requests_match_over_arrivals(case):
    sizes, order, keep, root = case
    shreds = _layout(sizes)
    forests = {n: m[0].Forest(0) for n, m in PKGS.items()}
    for k in order:
        if not keep[k]:
            continue                        # a gap: never arrives
        slot, idx, back, done = shreds[k]
        for f in forests.values():
            f.shred(slot, idx, parent_off=back, slot_complete=done)
        assert forests["port"].frontier() == forests["ref"].frontier()
        assert forests["port"].requests() == forests["ref"].requests()
    for f in forests.values():
        f.vote(len(sizes) + 3)              # an orphan known by a vote
        f.publish(min(root, len(sizes)))
    assert forests["port"].frontier() == forests["ref"].frontier()
    plans = {}
    for n, (_, pol, _) in PKGS.items():
        p = pol.RepairPolicy(CLIENT, max_inflight=4)
        p.set_peers([b"\x01" * 32, b"\x02" * 32])
        plans[n] = [p.plan(forests[n], now_ns=t, max_requests=12)
                    for t in (0, 50_000_000, 200_000_000)]
    assert plans["port"] == plans["ref"]


# -- RepairCore across the wire -------------------------------------------

class _Capture:
    def __init__(self):
        self.frames = []

    def publish(self, frame, sig=0):
        self.frames.append(bytes(frame))

    def credits(self, fseqs):
        return 1 << 30


class _Tap:
    """A UDP socket that also keeps what it sends."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.setblocking(False)
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append(bytes(data))
        return self.sock.sendto(data, addr)

    def recvfrom(self, n):
        return self.sock.recvfrom(n)


@pytest.fixture(scope="module")
def wires():
    """Slots 1..6 of a leader, two entry batches a slot (the second
    completes it): every shred wire in order."""
    sh = Shredder(lambda root: ed.sign(LEADER_SEED, root))
    out = []
    for slot in range(1, 7):
        for k in range(2):
            batch = bytes([slot, k]) * (150 + 40 * slot)
            for fs in sh.shred_batch(batch, slot, 1, 0, k == 1):
                out += fs.data_shreds + fs.parity_shreds
    return out


def _data(wires):
    return [w for w in wires if fmt.is_data(w[fmt.VARIANT_OFF])]


def _repair(client_pkg, server_pkg, wires):
    """The client saw every data shred but slot 3's and the second of
    slot 5's; it repairs from the server, which holds every wire.
    -> (requests sent, responses forwarded, the two cores' metrics)."""
    data = _data(wires)
    s5 = [w for w in data if fmt.parse_shred(w).slot == 5]
    lost = {w for w in data if fmt.parse_shred(w).slot == 3} | {s5[1]}
    ctap, stap = _Tap(), _Tap()
    try:
        server = PKGS[server_pkg][2].RepairCore(
            LEADER, lambda p: None, stap, root_slot=0)
        out = _Capture()
        client = PKGS[client_pkg][2].RepairCore(
            CLIENT, lambda p: ed.sign(CLIENT_SEED, p), ctap,
            peers=[(LEADER, stap.sock.getsockname())], root_slot=0,
            out_ring=out)
        for w in wires:
            server.on_shred(w)
        for w in data:
            if w not in lost:
                client.on_shred(w)
        for rnd in range(12):
            client.plan_and_send(now_ns=(rnd + 1) * 200_000_000)
            server.poll_socket(256)
            client.poll_socket(256)
            if not client.forest.frontier():
                break
        assert not client.forest.frontier(), client.forest.frontier()
        return ctap.sent, out.frames, dict(client.metrics), \
            dict(server.metrics)
    finally:
        ctap.sock.close()
        stap.sock.close()


@pytest.fixture(scope="module")
def ref_pair(wires):
    return _repair("ref", "ref", wires)


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_repair_across_the_wire_matches_reference(wires, ref_pair, client,
                                                  server):
    got = _repair(client, server, wires)
    assert got == ref_pair
    reqs, resps, cm, sm = got
    lost = {w for w in _data(wires) if fmt.parse_shred(w).slot == 3}
    assert lost <= set(resps) and set(resps) <= set(_data(wires))
    assert cm["reqs_sent"] == len(reqs) == sm["reqs_served"] \
        + sm["reqs_refused"]
    assert cm["resps_in"] == len(resps) > len(lost)
    assert cm["sign_fail"] == 0 and sm["reqs_served"] > 0
    for r in reqs:
        assert len(r) == jpolicy.REQ_LEN + 64
        assert ed.verify(r[jpolicy.REQ_LEN:], CLIENT, r[:jpolicy.REQ_LEN])


# -- the door ------------------------------------------------------------

@pytest.fixture
def clock(monkeypatch):
    now = [10 * 1_000_000_000]
    for mod in (jshed, tshed):
        monkeypatch.setattr(mod, "monotonic_ns", lambda: now[0])
    return now


def _door(repair_mod):
    """tests/test_flood.py:485's drill. -> every step's outcome."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.setblocking(False)
    try:
        core = repair_mod.RepairCore(
            b"\x01" * 32, lambda p: None, sock,
            shed={"rate_pps": 1000.0, "burst": 8, "max_peers": 8,
                  "min_stake": 1, "overload_hold_s": 30.0,
                  "stakes": {"127.0.0.1:65001": 500}})
        junk = (bytes(range(48)) * 4)[:jpolicy.REQ_LEN + 64]
        steps = [core.on_datagram(junk, (f"203.0.113.{i % 32 + 1}",
                                         4000 + i)) for i in range(64)]
        steps.append((dict(core.metrics), core.shed.counters()))
        core.shed.trip_overload()
        steps += [core.on_datagram(junk, (f"198.51.100.{i % 32 + 1}",
                                          7000 + i)) for i in range(64)]
        resp = b"\x00" * fmt.SHRED_MIN_SZ
        steps += [core.on_datagram(resp, ("9.9.9.9", 1)),
                  core.on_datagram(resp, ("127.0.0.1", 65001))]
        steps.append((dict(core.metrics), core.shed.counters(),
                      core.shed.shed_total))
        return steps
    finally:
        sock.close()


def test_repair_door_polices_as_reference(clock):
    ref, port = _door(jrepair), _door(trepair)
    assert port == ref
    m, gate, shed_total = port[-1]
    assert m["reqs_refused"] == 64 and m["resps_in"] == 1
    assert gate["peers"] <= 8 and shed_total >= 64 + 1


class _StubRing:
    def __init__(self):
        self.calls, self.pub = 0, []

    def credits(self, fseqs):
        self.calls += 1
        return 0 if self.calls == 1 else 1   # stalled, then drained

    def publish(self, data, sig=0):
        self.pub.append(bytes(data))


def test_repair_backpressure_trips_overload_as_reference(clock):
    out = {}
    for name, mod in (("ref", jrepair), ("port", trepair)):
        ring = _StubRing()
        core = mod.RepairCore(
            b"\x02" * 32, lambda p: None, sock=None, out_ring=ring,
            out_fseqs=[object()],
            shed={"rate_pps": 1000.0, "burst": 64, "max_peers": 8,
                  "min_stake": 1, "overload_hold_s": 30.0})
        before = core.shed.overloaded()
        n = core.on_datagram(b"\x00" * fmt.SHRED_MIN_SZ, ("10.0.0.7", 9))
        out[name] = (before, n, core.shed.overloaded(), ring.pub,
                     ring.calls, dict(core.metrics))
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (False, 1, True)


def test_repair_adapter_declares_the_reference_slots():
    assert TRepairAdapter.METRICS == JRepairAdapter.METRICS
    assert TRepairAdapter.GAUGES == JRepairAdapter.GAUGES
