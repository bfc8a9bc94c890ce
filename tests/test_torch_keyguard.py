"""The port's keyguard (firedancer_tpu_torch/keyguard/, with
protocol/txn.py's parse_message_shape) against the JAX package's: the
policy cases of tests/test_keyguard.py:30-91 on the port's `authorize`, the
whole (payload class x role x sign type) matrix equal to the reference's,
a SignTile / KeyguardClient round trip over the port's rings, the shred
tile's drop_slot_every seam beside the reference's, and the shred and
sign adapters' refusals of what the port has not ported."""
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.keyguard import keyguard as jkg
from firedancer_tpu.protocol import txn as jtxn
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.keyguard import (
    ROLE_GOSSIP, ROLE_LEADER, ROLE_REPAIR, ROLE_SEND, SIGN_TYPE_ED25519,
    SIGN_TYPE_SHA256_ED25519, KeyguardClient, SignHalted, SignTile,
    authorize)
from firedancer_tpu_torch.keyguard.keyguard import PING_TOKEN_PREFIX
from firedancer_tpu_torch.protocol.txn import (build_message,
                                               parse_message_shape)
from firedancer_tpu_torch.runtime import Ring, Workspace
from firedancer_tpu_torch.utils.ed25519_ref import keypair, verify

SEED = bytes(range(32))
_, _, IDENTITY = keypair(SEED)
ED, SHA = SIGN_TYPE_ED25519, SIGN_TYPE_SHA256_ED25519


def vote_message() -> bytes:
    return build_message([IDENTITY], [b"\x07" * 32], b"\x01" * 32,
                         [(1, bytes([0]), b"vote-ix-data")])


def test_leader_signs_only_merkle_roots():
    root = os.urandom(32)
    assert authorize(IDENTITY, root, ROLE_LEADER, ED)
    assert not authorize(IDENTITY, root + b"x", ROLE_LEADER, ED)
    assert not authorize(IDENTITY, vote_message(), ROLE_LEADER, ED)


def test_send_signs_only_txn_messages():
    assert authorize(IDENTITY, vote_message(), ROLE_SEND, ED)
    assert not authorize(IDENTITY, os.urandom(32), ROLE_SEND, ED)
    assert not authorize(IDENTITY, os.urandom(200), ROLE_SEND, ED)


def test_gossip_ping_pong_prune():
    ping = PING_TOKEN_PREFIX + os.urandom(16)
    assert authorize(IDENTITY, ping, ROLE_GOSSIP, ED)
    pong = PING_TOKEN_PREFIX + os.urandom(32)
    assert authorize(IDENTITY, pong, ROLE_GOSSIP, SHA)
    assert not authorize(IDENTITY, pong, ROLE_GOSSIP, ED)
    assert authorize(IDENTITY, IDENTITY + os.urandom(32), ROLE_GOSSIP, ED)
    assert authorize(IDENTITY, os.urandom(64), ROLE_GOSSIP, ED)
    repair = (9).to_bytes(4, "little") + IDENTITY + os.urandom(60)
    assert not authorize(IDENTITY, repair, ROLE_GOSSIP, ED)


def test_repair_requires_own_sender_pubkey():
    body = os.urandom(60)
    assert authorize(IDENTITY, (9).to_bytes(4, "little") + IDENTITY + body,
                     ROLE_REPAIR, ED)
    assert not authorize(IDENTITY, (9).to_bytes(4, "little")
                         + os.urandom(32) + body, ROLE_REPAIR, ED)
    assert not authorize(IDENTITY, (7).to_bytes(4, "little") + IDENTITY
                         + body, ROLE_REPAIR, ED)
    assert not authorize(IDENTITY, os.urandom(32), ROLE_REPAIR, ED)


def test_oversize_refused():
    assert not authorize(IDENTITY, b"\x00" * 2000, ROLE_GOSSIP, ED)


def _payloads():
    rng = np.random.default_rng(12)
    rb = rng.bytes
    v0 = b"\x80" + vote_message() + b"\x00"       # a v0 message, no ALUTs
    return {
        "root": rb(32), "root_ping": PING_TOKEN_PREFIX + rb(16),
        "pong": PING_TOKEN_PREFIX + rb(32), "prune": IDENTITY + rb(32),
        "crds": rb(64), "repair": (9).to_bytes(4, "little") + IDENTITY
        + rb(60), "repair_other": (10).to_bytes(4, "little") + rb(32)
        + rb(60), "vote": vote_message(), "vote_v0": v0,
        "vote_cut": vote_message()[:-3], "empty": b"", "big": bytes(1281),
        "short": rb(7)}


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_authorize_matrix_matches_reference(name):
    data = _payloads()[name]
    for role in (ROLE_SEND, ROLE_GOSSIP, ROLE_LEADER, ROLE_REPAIR):
        for st in (ED, SHA):
            assert authorize(IDENTITY, data, role, st) == \
                jkg.authorize(IDENTITY, data, role, st), (role, st)
    assert parse_message_shape(data) == jtxn.parse_message_shape(data)


def test_sign_tile_and_client_round_trip():
    """A client blocks on the response ring while the tile polls in
    another thread: a root signed by the leader leg, a vote message
    refused there and signed by the send leg."""
    w = Workspace(f"/fdtt_kg{os.getpid()}", 1 << 21)
    try:
        req_l, req_s = (Ring.create(w, depth=16, mtu=1280) for _ in "ls")
        rsp_l, rsp_s = (Ring.create(w, depth=16, mtu=128) for _ in "ls")
        tile = SignTile(SEED, [
            {"role": ROLE_LEADER, "in_ring": req_l, "out_ring": rsp_l,
             "out_fseqs": []},
            {"role": ROLE_SEND, "in_ring": req_s, "out_ring": rsp_s,
             "out_fseqs": []}])
        stop = threading.Event()

        def serve():
            while not stop.is_set():
                tile.poll_once()
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        leader = KeyguardClient(req_l, rsp_l)
        sender = KeyguardClient(req_s, rsp_s)
        try:
            roots = [os.urandom(32) for _ in range(3)]
            for r in roots:
                assert verify(leader.sign(r, timeout_s=30), IDENTITY, r)
            msg = vote_message()
            assert leader.sign(msg, timeout_s=30) is None
            assert verify(sender.sign(msg, timeout_s=30), IDENTITY, msg)
        finally:
            stop.set()
            th.join(5)
        assert tile.metrics["signed"] == 4 and tile.metrics["refused"] == 1
        assert tile.seqs == [4, 1]
    finally:
        w.close()
        w.unlink()


def _ctx(w, spec=None):
    rings = {ln: Ring.create(w, depth=16, mtu=m) for ln, m in
             (("entries", 1280), ("req", 1280), ("resp", 128))}
    return SimpleNamespace(
        tile_name="t", spec=spec or {},
        plan={"links": {ln: {"mtu": r.mtu} for ln, r in rings.items()}},
        in_rings={"entries": rings["entries"], "resp": rings["resp"]},
        out_rings={"req": rings["req"]}, out_fseqs={"req": []},
        in_seq0={"entries": 0, "resp": 0})


def test_shred_adapter_refuses_recover_mode_and_boots_leader():
    """Both modes boot (recover mode is ported: its in links are shred
    wires, its one out link the slices) and an unknown mode is refused;
    the leader boots on its keyguard links."""
    w = Workspace(f"/fdtt_kga{os.getpid()}", 1 << 21)
    try:
        ctx = _ctx(w)
        with pytest.raises(ValueError, match="mode 'follow'"):
            ttiles.REGISTRY["shred"](ctx, {"mode": "follow"})
        r = ttiles.REGISTRY["shred"](ctx, {"mode": "recover",
                                           "leader_pubkey_hex": "00" * 32})
        assert r.poll_once() == 0
        assert r.in_seqs() == {"entries": 0, "resp": 0}
        assert set(r.metrics_items()) == set(ttiles.REGISTRY["shred"].METRICS)
        a = ttiles.REGISTRY["shred"](ctx, {
            "req": "req", "resp": "resp", "identity_hex": IDENTITY.hex()})
        assert a.poll_once() == 0
        assert a.in_seqs() == {"entries": 0, "resp": 0}
        assert set(a.metrics_items()) == set(ttiles.REGISTRY["shred"].METRICS)
    finally:
        w.close()
        w.unlink()


def test_shred_adapter_stops_a_sign_wait_when_its_tile_halts():
    """A topology halts every tile at once: a FEC set's sign request
    that the gone sign tile will not answer ends the poll as soon as the
    shred tile's cnc leaves RUN, instead of after the client's 30 s
    timeout, and counts no sign failure."""
    import struct
    import time

    from firedancer_tpu_torch.runtime import CNC_HALT, CNC_RUN
    w = Workspace(f"/fdtt_kgh{os.getpid()}", 1 << 21)
    try:
        ctx = _ctx(w)
        ctx.cnc = SimpleNamespace(state=CNC_RUN)
        a = ttiles.REGISTRY["shred"](ctx, {
            "req": "req", "resp": "resp", "identity_hex": IDENTITY.hex()})
        ctx.cnc.state = CNC_HALT
        frame = (struct.pack("<QIIB", 3, 0, 8, 0) + bytes(96)
                 + bytes([1]) + struct.pack("<H", 0))
        ctx.in_rings["entries"].publish(frame, sig=0)
        t0 = time.monotonic()
        assert a.poll_once() == 1
        assert time.monotonic() - t0 < 5
        m = a.metrics_items()
        assert m["entries"] == 1 and m["sign_fail"] == 0
        assert m["fec_sets"] == 0
        with pytest.raises(SignHalted):
            KeyguardClient(ctx.out_rings["req"], ctx.in_rings["resp"],
                           cnc=ctx.cnc).sign(bytes(32))
    finally:
        w.close()
        w.unlink()


def test_shred_drop_slot_every_is_refused_with_its_item():
    """The reference's fault seam, refused until the repair tile was
    ported, is accepted by the config gate and Topology.tile and drops
    the slots it names: with drop_slot_every = 4, slots 3 and 7 reach no
    turbine peer (counted in `dropped`) and are still mirrored, the
    other slots are sent, and every count, send and mirrored wire is the
    reference ShredLeaderCore's."""
    import struct

    from firedancer_tpu.tiles import shred as jshred
    from firedancer_tpu.shred import shred_dest as jdest
    from firedancer_tpu.utils import ed25519_ref as jed
    from firedancer_tpu_torch.app import config as tconfig
    from firedancer_tpu_torch.disco.topo import Topology
    from firedancer_tpu_torch.shred import format as fmt
    from firedancer_tpu_torch.shred import shred_dest as tdest
    from firedancer_tpu_torch.tiles import shred as tshred
    from firedancer_tpu_torch.utils import ed25519_ref as ted
    topo = Topology("kgd").tile("shred", "shred", drop_slot_every=4)
    assert topo.tiles["shred"].args["drop_slot_every"] == 4
    toml = os.path.join(os.path.dirname(tconfig.__file__), os.pardir,
                        "cfg", "leader.toml")
    cfg = tconfig.load_config(toml, overrides={
        "tile": [{"name": "shred", "drop_slot_every": 4}]})
    assert tconfig.build_topology(cfg).tiles["shred"].args[
        "drop_slot_every"] == 4

    class Sock:
        def __init__(self):
            self.sent = []

        def sendto(self, wire, addr):
            self.sent.append(bytes(wire))

    frames = [struct.pack("<QIIB", slot, 0, 8, 0) + bytes(96) + bytes([1])
              + struct.pack("<H", 0) for slot in range(9)]
    out = {}
    for name, mod, dest, ed in (("ref", jshred, jdest, jed),
                                ("port", tshred, tdest, ted)):
        sock = Sock()
        core = mod.ShredLeaderCore(
            lambda r, ed=ed: ed.sign(SEED, r), IDENTITY,
            [dest.ClusterNode(b"\x55" * 32, 100, ("127.0.0.1", 9))], sock,
            drop_slot_every=4)
        for f in frames:
            core.on_entry(f)
        out[name] = (sock.sent, dict(core.metrics))
    assert out["port"] == out["ref"]
    sent, m = out["port"]
    sent_slots = {fmt.parse_shred(w).slot for w in sent}
    assert sent_slots == set(range(9)) - {3, 7}
    assert m["slots"] == 9 and m["dropped"] > 0
    assert m["dropped"] + m["sent"] == m["data_shreds"] + m["parity_shreds"]


def test_sign_adapter_refuses_a_keyswitch_region():
    w = Workspace(f"/fdtt_kgb{os.getpid()}", 1 << 21)
    try:
        args = {"seed": SEED.hex(), "clients": [
            {"role": "leader", "req": "entries", "resp": "req"}]}
        with pytest.raises(NotImplementedError, match="queue A item 13$"):
            ttiles.REGISTRY["sign"](_ctx(w, {"keyswitch_off": 4096}), args)
        a = ttiles.REGISTRY["sign"](_ctx(w), args)
        assert a.poll_once() == 0 and a.in_seqs() == {"entries": 0}
    finally:
        w.close()
        w.unlink()
