"""The port's gossip wire codec (firedancer_tpu_torch/flamenco/
gossip_wire.py) against the reference's: every message kind encoded by
both packages to equal bytes and parsed by both to equal views, the
CRDS payload codecs round-tripping, the hostile datagrams of
tests/test_gossip_wire.py, and seeded mutations of valid datagrams
(truncations, byte flips, splices), which both parsers must reject or
read alike. Host code only: exact."""
import hashlib
import struct

import numpy as np
import pytest

from firedancer_tpu.flamenco import gossip_wire as rgw
from firedancer_tpu_torch.flamenco import gossip_wire as tgw
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.utils.ed25519_ref import keypair, sign

SEED = bytes(range(32))
PUB = keypair(SEED)[2]
TXN = make_signed_txns(1, seed=5)[0]
WC = struct.pack("<Q", 123)


def _contact_info(gw):
    return gw.ContactInfo(
        pubkey=PUB, wallclock_ms=987_654_321, outset_us=17,
        shred_version=50093, version=(0, 6, 3), commit=0xDEADBEEF,
        feature_set=1234, client=gw.CLIENT_FIREDANCER,
        sockets={gw.SOCKET_GOSSIP: ("127.0.0.1", 8001),
                 gw.SOCKET_TVU: ("127.0.0.1", 8002),
                 gw.SOCKET_TPU: ("10.0.0.7", 8003),
                 gw.SOCKET_RPC: ("127.0.0.1", 7000)},
        extensions=(3, 4))


def _payloads(gw):
    """(tag, payload) of every CRDS kind the codec builds or scans."""
    return [
        (gw.V_CONTACT_INFO, _contact_info(gw).encode()),
        (gw.V_VOTE, gw.encode_vote(3, PUB, TXN, 1000)),
        (gw.V_NODE_INSTANCE, gw.encode_node_instance(PUB, 123, 5, 6)),
        (gw.V_LOWEST_SLOT, gw.encode_lowest_slot(PUB, 77, 123)),
        (gw.V_ACCOUNT_HASHES, PUB + struct.pack("<Q", 2)
         + (struct.pack("<Q", 5) + bytes(32)) * 2 + WC),
        (gw.V_INC_SNAPSHOT_HASHES, PUB + struct.pack("<Q", 9) + bytes(32)
         + struct.pack("<Q", 1) + struct.pack("<Q", 10) + bytes(32) + WC),
        (gw.V_EPOCH_SLOTS, bytes([0]) + PUB + struct.pack("<Q", 1)
         + struct.pack("<I", 1) + struct.pack("<QQ", 7, 8)
         + bytes([1]) + struct.pack("<Q", 2) + bytes(2)
         + struct.pack("<Q", 16) + WC),
        (gw.V_DUPLICATE_SHRED, struct.pack("<H", 1) + PUB + WC
         + struct.pack("<Q", 9) + bytes(5) + bytes([2, 0])
         + struct.pack("<Q", 3) + b"abc"),
        (gw.V_RESTART_HEAVIEST_FORK, PUB + WC + struct.pack("<Q", 4)
         + bytes(32) + struct.pack("<Q", 11) + struct.pack("<H", 1)),
    ]


def _value(gw, tag, payload):
    return gw.encode_value(tag, payload, sign(SEED, gw.signable(tag, payload)))


def _messages(gw):
    """One datagram of every message kind, by the package `gw`."""
    vals = [_value(gw, t, p) for t, p in _payloads(gw)]
    ci = vals[0]
    origins = [hashlib.sha256(b"%d" % i).digest() for i in range(3)]
    dest = hashlib.sha256(b"dest").digest()
    token = hashlib.sha256(b"tok").digest()
    psig = sign(SEED, gw.prune_signable(PUB, origins, dest, 777))
    return {
        "push": gw.encode_container(gw.MSG_PUSH, PUB, vals[:5]),
        "push_tail": gw.encode_container(gw.MSG_PUSH, PUB, vals[5:]),
        "pull_response": gw.encode_container(gw.MSG_PULL_RESPONSE, PUB,
                                             vals[1:3]),
        "pull_request": gw.encode_pull_request(
            [7, 11], struct.pack("<4Q", 1, 2, 4, 8), 4, 0xFFFF, 16, ci),
        "pull_request_bits": gw.encode_pull_request(
            [1 << 63], struct.pack("<2Q", 3, 5), 3, 0, 0, ci, bits_cnt=70),
        "prune": gw.encode_prune(PUB, origins, psig, dest, 777),
        "ping": gw.encode_ping(PUB, token, sign(SEED, token)),
        "pong": gw.encode_pong(PUB, token, sign(
            SEED, hashlib.sha256(gw.pong_preimage(token)).digest())),
    }


KINDS = sorted(_messages(tgw))


def _parse(gw, data):
    try:
        return ("ok", gw.parse_message(data))
    except (gw.WireError, ValueError, struct.error, IndexError) as e:
        return ("bad", type(e).__name__)


@pytest.mark.parametrize("kind", KINDS)
def test_every_message_kind_equal_bytes_and_views(kind):
    data = _messages(tgw)[kind]
    assert data == _messages(rgw)[kind]
    got, want = _parse(tgw, data), _parse(rgw, data)
    assert got[0] == "ok" and got == want


@pytest.mark.parametrize("i", range(len(_payloads(tgw))))
def test_crds_values_round_trip(i):
    tag, payload = _payloads(tgw)[i]
    assert (tag, payload) == _payloads(rgw)[i]
    wire = _value(tgw, tag, payload)
    v, end = tgw.decode_value(wire, 0)
    assert end == len(wire) and v == rgw.decode_value(wire, 0)[0]
    assert v["payload"] == payload and v["origin"] == PUB
    assert tgw.value_hash(wire) == rgw.value_hash(wire)


def test_payload_codecs_round_trip():
    ci = _contact_info(tgw)
    enc = ci.encode()
    got, end = tgw.ContactInfo.decode(enc, 0)
    assert end == len(enc) and got == ci
    ref = rgw.ContactInfo.decode(enc, 0)[0]
    assert (got.sockets, got.extensions, got.gossip_addr()) == \
        (ref.sockets, ref.extensions, ref.gossip_addr())
    vote = tgw.encode_vote(3, PUB, TXN, 1000)
    assert tgw.decode_vote(vote, 0) == rgw.decode_vote(vote, 0)
    assert tgw.decode_vote(vote, 0)[0]["txn"] == TXN
    ni = tgw.encode_node_instance(PUB, 123, 5, 6)
    assert tgw.decode_node_instance(ni, 0) == rgw.decode_node_instance(ni, 0)
    ls = tgw.encode_lowest_slot(PUB, 77, 123)
    assert tgw.decode_lowest_slot(ls, 0) == rgw.decode_lowest_slot(ls, 0)
    for prefixed in (True, False):
        assert tgw.prune_signable(PUB, [PUB], PUB, 5, prefixed) == \
            rgw.prune_signable(PUB, [PUB], PUB, 5, prefixed)
    for v in (0, 127, 128, 0xFFFF, 1 << 40):
        assert tgw.enc_varint(v) == rgw.enc_varint(v)
        assert tgw.dec_varint(tgw.enc_varint(v), 0) == (v, len(
            tgw.enc_varint(v)))


HOSTILE = {
    "unknown_tag": struct.pack("<I", 9) + bytes(32),
    "trailing": tgw.encode_ping(PUB, bytes(32), bytes(64)) + b"x",
    "crds_count": struct.pack("<I", tgw.MSG_PUSH) + PUB
    + struct.pack("<Q", 500),
    "empty": b"",
    "short_tag": b"\x02\x00",
    "over_mtu": struct.pack("<I", tgw.MSG_PING) + bytes(1300),
    "truncated_value": struct.pack("<I", tgw.MSG_PUSH) + PUB
    + struct.pack("<Q", 1) + bytes(40),
    "bad_crds_tag": tgw.encode_container(tgw.MSG_PUSH, PUB,
                                         [bytes(64) + struct.pack("<I", 99)
                                          + bytes(60)]),
    "bloom_without_bits": struct.pack("<IQ", tgw.MSG_PULL_REQUEST, 0)
    + b"\x00" + bytes(40),
    "prune_from_mismatch": struct.pack("<I", tgw.MSG_PRUNE) + PUB
    + bytes(32) + bytes(120),
    "truncated_pong": struct.pack("<I", tgw.MSG_PONG) + bytes(100),
}


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_datagrams_rejected_alike(name):
    got = _parse(tgw, HOSTILE[name])
    assert got[0] == "bad"
    assert got == _parse(rgw, HOSTILE[name])
    with pytest.raises(tgw.WireError):
        tgw.encode_vote(32, PUB, b"", 0)


def _prune_count_overruns(data: bytes) -> bool:
    """A PruneMessage whose origin count runs past the datagram: the
    port refuses it before building the origin list; the reference
    would first build a list of that many slices (a count near 2^64
    holds it), so it is not run on those."""
    if len(data) < 76 or struct.unpack_from("<I", data)[0] != tgw.MSG_PRUNE:
        return False
    (n,) = struct.unpack_from("<Q", data, 68)
    return 76 + 32 * n > len(data)


@pytest.mark.parametrize("seed", range(6))
def test_mutated_datagrams_parse_alike(seed):
    """Seeded truncations, byte flips and splices of every kind: both
    parsers reject or accept each alike, and accepted views are
    equal."""
    rng = np.random.default_rng(seed)
    msgs = list(_messages(tgw).values())
    accepted = rejected = 0
    for _ in range(300):
        base = bytearray(msgs[int(rng.integers(len(msgs)))])
        r = rng.random()
        if r < 0.3:
            base = base[:int(rng.integers(len(base)))]
        elif r < 0.8:
            for _ in range(int(rng.integers(1, 4))):
                base[int(rng.integers(len(base)))] = int(rng.integers(256))
        else:
            other = msgs[int(rng.integers(len(msgs)))]
            cut = int(rng.integers(len(base)))
            base = base[:cut] + other[int(rng.integers(len(other))):]
        data = bytes(base)
        got = _parse(tgw, data)
        if _prune_count_overruns(data):
            assert got == ("bad", "WireError")
            rejected += 1
            continue
        want = _parse(rgw, data)
        assert got[0] == want[0], data.hex()
        if got[0] == "ok":
            assert got == want
            accepted += 1
        else:
            rejected += 1
    assert accepted and rejected
