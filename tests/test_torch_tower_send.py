"""The port's tower and send tiles (tiles/tower.py: TowerCore, SendCore,
the vote frame; disco/tiles.py: TowerAdapter, SendAdapter) against the
reference's: the core cases of tests/test_tower_send.py, the threshold
cases included, in lockstep (tests/torch_lockstep.py); seeded streams of
BLOCK and VOTE frames with hostile ones among them (empty, short,
non-advancing, unknown type, votes before any block, a rival fork) give
the same decisions, towers and metrics; SendCore signs byte-identical
TowerSync txns through a keyguard of the same seed; and tower -> send ->
sign runs as a spawned topology on the CPU, whose vote txn is the
reference SendCore's for the same tower, byte for byte."""
import os
import random
import socket
import struct
import time

import pytest

import test_tower_send
from torch_lockstep import lockstep

from firedancer_tpu import keyguard as jkg
from firedancer_tpu.tiles import tower as jtower
from firedancer_tpu.utils import ed25519_ref as jed
from firedancer_tpu_torch import keyguard as tkg
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.protocol.txn import parse_txn
from firedancer_tpu_torch.runtime import Ring
from firedancer_tpu_torch.svm.vote import VOTE_PROGRAM_ID
from firedancer_tpu_torch.tiles import tower as ttower
from firedancer_tpu_torch.utils import ed25519_ref as ted

SEED = bytes(range(32))
IDENTITY = ted.keypair(SEED)[-1]
VOTE_ACCT = b"\x42" * 32
NAMES = {"TowerCore": "tiles.tower.TowerCore",
         "pack_block": "tiles.tower.pack_block",
         "pack_vote": "tiles.tower.pack_vote"}


def bid(n):
    return n.to_bytes(32, "little")


@pytest.mark.parametrize("case", sorted(
    n for n in vars(test_tower_send)
    if n.startswith(("test_tower_core", "test_tower_threshold"))))
def test_tower_core_cases_match_reference(case):
    rec = lockstep(getattr(test_tower_send, case), NAMES)
    assert any(r[:2] == ("TowerCore", "decide") for r in rec)


def _frames(seed, n=160):
    """A chain with forks, votes from a few voters (some for unknown
    blocks), and hostile frames."""
    rng = random.Random(seed)
    frames, known, slot = [], [(0, bid(0))], 0
    voters = [bytes([v + 1]) * 32 for v in range(5)]
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            ps, pb = known[-1] if rng.random() < 0.8 else rng.choice(known)
            slot += 1
            b = bid(1000 * seed + slot)
            frames.append(jtower.pack_block(slot, ps, b, pb))
            known.append((slot, b))
        elif r < 0.8:
            b = rng.choice(known)[1] if rng.random() < 0.9 else bid(99999)
            frames.append(jtower.pack_vote(rng.choice(voters),
                                           rng.choice((5, 10, 30, 60)), b))
        else:
            frames.append(rng.choice([
                b"", b"\x00" * 40, b"\x01" * 50, b"\x07" + bytes(80),
                jtower.pack_block(3, 3, bid(3), bid(2)),
                jtower.pack_block(2, 5, bid(77), bid(0))]))
    return frames


@pytest.mark.parametrize("seed", range(4))
def test_tower_core_hostile_streams_match_reference(seed):
    frames = _frames(seed)
    out = {}
    for name, mod in (("ref", jtower), ("port", ttower)):
        core = mod.TowerCore(total_stake=100)
        decisions = []
        for k, f in enumerate(frames):
            core.handle(f)
            if k % 3 == 2:
                decisions.append(core.decide())
        out[name] = (decisions, dict(core.metrics),
                     [(v.slot, v.conf) for v in core.tower.votes],
                     core.tower.root)
    assert out["port"] == out["ref"]
    decisions, metrics = out["port"][:2]
    assert metrics["bad_frames"] > 0 and any(decisions)


class _Keyguard:
    """The sign tile's policy and signature in process: a SEND-role
    request that is not a txn message is refused."""

    def __init__(self, kg, ed, seed):
        self.kg, self.ed, self.seed = kg, ed, seed
        self.pub = ed.keypair(seed)[-1]

    def sign(self, msg):
        if not self.kg.authorize(self.pub, msg, self.kg.ROLE_SEND,
                                 self.kg.SIGN_TYPE_ED25519):
            return None
        return self.ed.sign(self.seed, msg)


class _Sock:
    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((bytes(data), addr))


def _sent(mod, kg, ed, votes):
    sock = _Sock()
    core = mod.SendCore(IDENTITY, VOTE_ACCT, _Keyguard(kg, ed, SEED),
                        ("127.0.0.1", 9), sock)
    ok = [core.send_vote(*v) for v in votes]
    return ok, sock.sent, dict(core.metrics)


def test_send_core_txns_byte_identical():
    votes = [(5, bid(5), None, None), (6, bid(6), [(5, 2), (6, 1)], None),
             (40, bid(40), [(s, 32 - s + 9) for s in range(9, 40)], 8)]
    ref = _sent(jtower, jkg, jed, [(s, b, lo, r) for s, b, lo, r in votes])
    port = _sent(ttower, tkg, ted, votes)
    assert port == ref
    assert port[0] == [True] * 3 and port[2]["sign_fail"] == 0
    t = parse_txn(port[1][2][0])
    data = port[1][2][0]
    assert t.account_keys(data)[0] == IDENTITY
    assert ted.verify(t.signatures(data)[0], IDENTITY, t.message(data))


def test_vote_frame_round_trip():
    core = ttower.TowerCore(total_stake=100)
    for s in range(1, 40):
        core.tower.vote(s)
    frame = ttower.pack_tower_vote(39, bid(39), core.tower)
    slot, block_id, lockouts, root = ttower.parse_tower_vote(frame)
    assert (slot, block_id, root) == (39, bid(39), core.tower.root)
    assert lockouts == [(v.slot, v.conf) for v in core.tower.votes][-31:]
    assert ttower.parse_tower_vote(frame[:40]) == (39, bid(39), [], None)


def test_tower_send_sign_topology_on_the_cpu():
    """tests/test_tower_send.py:70 on the port's tiles: a BLOCK and a
    VOTE frame into the tower tile; the send tile's UDP datagram is a
    TowerSync txn signed by the sign tile's identity, byte for byte the
    reference SendCore's for the same vote frame."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(60)
    dest = f"127.0.0.1:{rx.getsockname()[1]}"
    topo = (
        Topology(f"ttw{os.getpid()}", wksp_size=1 << 23)
        .link("replay_tower", depth=64, mtu=128)
        .link("tower_votes", depth=32, mtu=512)
        .link("send_req", depth=16, mtu=1280)
        .link("sign_resp", depth=16, mtu=128)
        .tile("feed", "synth", outs=["replay_tower"], count=0)
        .tile("tower", "tower", ins=[("replay_tower", False)],
              outs=["tower_votes"], total_stake=100)
        .tile("send", "send", ins=["tower_votes", ("sign_resp", False)],
              outs=["send_req"], identity_hex=IDENTITY.hex(),
              vote_account_hex=VOTE_ACCT.hex(), dest=dest,
              req="send_req", resp="sign_resp")
        .tile("sign", "sign", ins=[("send_req", False)],
              outs=["sign_resp"], seed=SEED.hex(),
              clients=[{"role": "send", "req": "send_req",
                        "resp": "sign_resp"}]))
    plan = topo.build()
    runner = TopologyRunner(plan).start(tiles=["tower", "send", "sign"])
    try:
        runner.wait_running(timeout_s=120)
        li = plan["links"]["replay_tower"]
        feed = Ring(runner.wksp, li["ring_off"], li["depth"],
                    li["arena_off"], li["mtu"])
        feed.publish(ttower.pack_block(5, 4, bid(5), bid(4)), sig=0)
        feed.publish(ttower.pack_vote(b"w1" * 16, 70, bid(5)), sig=1)
        data, _ = rx.recvfrom(2048)
        t = parse_txn(data)
        keys = t.account_keys(data)
        assert keys[0] == IDENTITY and VOTE_PROGRAM_ID in keys
        assert ted.verify(t.signatures(data)[0], IDENTITY, t.message(data))
        ix = t.instrs[0]
        disc, cnt = struct.unpack_from("<IQ", data, ix.data_off)
        slot, conf = struct.unpack_from("<QI", data, ix.data_off + 12)
        assert (disc, cnt, slot, conf) == (14, 1, 5, 1)
        # the reference's send core on the tower the frame carried
        ref = jtower.SendCore(IDENTITY, VOTE_ACCT,
                              _Keyguard(jkg, jed, SEED), ("h", 1), _Sock())
        ref.send_vote(5, bid(5), lockouts=[(5, 1)], root=None)
        assert ref.sock.sent[0][0] == data
        deadline = time.monotonic() + 30
        while runner.metrics("send")["sent"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        m = runner.metrics("tower")
        assert m["votes_out"] == 1 and m["blocks"] == 1 \
            and m["votes_in"] == 1
        assert runner.metrics("send")["sign_fail"] == 0
        assert runner.metrics("sign")["signed"] == 1
    finally:
        runner.halt()
        runner.close()
        rx.close()
