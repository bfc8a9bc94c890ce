"""The port's QUIC door (waltz/quic.py, tiles/quic.py and disco/tiles.py's
QuicAdapter, copies of the JAX package's) against the reference's: the
RFC 9001 A.1 keys; varints and packet numbers; long and short packets
sealed byte for byte; a server and client of each package in process
under one seeded entropy stream, through a handshake, txns, a multi-packet
stream out of order, garbage, a replay, a stream that never FINs, a
forged Initial and a client that withholds its Finished, sending the same
datagrams both ways and ending with the same metrics; the reference's own
in-process tests (tests/test_quic.py) run on both packages in lockstep
(tests/torch_lockstep.py) under the same seeded `os.urandom`; the ALPN
refusal; the malformed flood of tests/test_flood.py:417-437 and a
client's txns on both QuicTiles with equal metrics and frags; and
cfg/quic.toml booted on the CPU, its verify tile on the plain versions,
with txns over real QUIC. Host code only: exact."""
import collections
import os
import random
import socket
import struct
import threading
import time

import pytest

import test_quic
from torch_lockstep import ROOTS, run_on, seeded_urandom as stream

from firedancer_tpu import runtime as jrt
from firedancer_tpu.disco import shed as rshed
from firedancer_tpu.tiles.quic import QuicTile as RefQuicTile
from firedancer_tpu.waltz import quic as jq
from firedancer_tpu.waltz import tls as jtls
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.disco import shed as tshed
from firedancer_tpu_torch.tiles.quic import QuicTile
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.utils import chaos as tchaos
from firedancer_tpu_torch.waltz import quic as tq
from firedancer_tpu_torch.waltz import tls as ttls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIC_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "quic.toml")


# -- keys, varints, packet numbers, sealing ---------------------------------

def test_rfc9001_initial_keys_equal_reference():
    ck, sk, isec = tq.initial_keys(bytes.fromhex("8394c8f03e515708"))
    assert (ck.key.hex(), ck.iv.hex(), ck.hp.hex()) == (
        "1f369613dd76d5467730efcbe3b1a22d", "fa044b2f42a3fd3b46fb255c",
        "9f50449e04a0e810283a1e9933adedd2")
    assert (sk.key.hex(), sk.iv.hex(), sk.hp.hex()) == (
        "cf3a5331653c364c88f0f379b6067e37", "0ac1493ca1905853b0bba03e",
        "c206b8d9b9f0f37644430b490eeaa314")
    draw = stream(9001)
    for _ in range(8):
        dcid = draw(1 + draw(1)[0] % 20)
        got = tq.initial_keys(dcid)
        want = jq.initial_keys(dcid)
        assert [(k.key, k.iv, k.hp) for k in got[:2]] == \
            [(k.key, k.iv, k.hp) for k in want[:2]] and got[2] == want[2]


def test_varints_and_packet_numbers_equal_reference():
    rng = random.Random(16)
    vals = [0, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30,
            (1 << 62) - 1] + [rng.getrandbits(rng.randrange(1, 63))
                              for _ in range(200)]
    for v in vals:
        b = tq.enc_varint(v)
        assert b == jq.enc_varint(v)
        assert tq.dec_varint(b + b"\x00", 0) == jq.dec_varint(
            b + b"\x00", 0) == (v, len(b))
    for mod in (tq, jq):
        with pytest.raises(mod.QuicError):
            mod.enc_varint(1 << 62)
        with pytest.raises(mod.QuicError):
            mod.dec_varint(b"\xc0\x00", 0)
    assert tq.decode_pn(0x9b32, 2, 0xa82f30ea) == 0xa82f9b32
    for _ in range(2000):
        pn_len = rng.choice((1, 2, 4))
        largest = rng.randrange(-1, 1 << 40)
        trunc = rng.getrandbits(8 * pn_len)
        assert tq.decode_pn(trunc, pn_len, largest) == \
            jq.decode_pn(trunc, pn_len, largest)


def test_long_and_short_packets_sealed_equal_reference():
    draw = stream(17)
    for i in range(24):
        dcid, scid = draw(8), draw(1 + i % 20)
        tk = tq.initial_keys(dcid)[0]
        jk = jq.initial_keys(dcid)[0]
        pn = int.from_bytes(draw(3), "big")
        payload = tq.enc_crypto_frame(i * 7, draw(i * 50)) + bytes(i % 5)
        for ptype in (tq.PT_INITIAL, tq.PT_HANDSHAKE):
            # a long header's pn opens as its two wire bytes (no
            # reconstruction, as the reference's: its spaces stay small)
            pkt = tq.seal_long(tk, ptype, dcid, scid, pn & 0xFFFF, payload)
            assert pkt == jq.seal_long(jk, ptype, dcid, scid, pn & 0xFFFF,
                                       payload)
            assert tq.open_long(tk, pkt) == jq.open_long(jk, pkt)
            assert tq.long_header_len(pkt) == jq.long_header_len(pkt)
        data = draw(i * 40)
        frame = tq.enc_stream_frame(2 + 4 * i, i * 100, data, bool(i % 2))
        assert frame == jq.enc_stream_frame(2 + 4 * i, i * 100, data,
                                            bool(i % 2))
        pkt = tq.seal_short(tk, dcid, pn, frame)
        assert pkt == jq.seal_short(jk, dcid, pn, frame)
        got = tq.open_short(tk, pkt, 8, pn - 1)
        assert got == jq.open_short(jk, pkt, 8, pn - 1)
        assert list(tq.parse_frames(got[1])) == \
            list(jq.parse_frames(got[1]))
        bad = bytearray(pkt)
        bad[-1] ^= 1
        for mod, k in ((tq, tk), (jq, jk)):
            with pytest.raises(mod.QuicError, match="AEAD"):
                mod.open_short(k, bytes(bad), 8, pn - 1)


# -- a server and a client in process, both packages -------------------------

class Net:
    """Datagrams between in-process endpoints: each sendto is logged and
    queued for its destination; a client's read of an empty queue first
    runs the server over its own queue."""

    def __init__(self):
        self.q = collections.defaultdict(collections.deque)
        self.log = []
        self.server = None

    def pump(self):
        """The server reads everything queued for it -> datagrams read."""
        n = 0
        while self.q[SRV]:
            data, addr = self.q[SRV].popleft()
            self.server.on_datagram(data, addr)
            n += 1
        return n


SRV = ("10.0.0.1", 8001)


class Sock:
    def __init__(self, net, addr):
        self.net, self.addr = net, addr

    def sendto(self, data, addr):
        self.net.log.append((self.addr, addr, bytes(data)))
        self.net.q[addr].append((bytes(data), self.addr))

    def recvfrom(self, n):
        q = self.net.q[self.addr]
        if not q and self.addr != SRV:
            self.net.pump()
        if not q:
            raise TimeoutError if self.addr != SRV else BlockingIOError
        return q.popleft()

    def settimeout(self, t):
        pass

    def setblocking(self, b):
        pass

    def getsockname(self):
        return self.addr


def _session(quic) -> dict:
    """The whole exchange with one package: every datagram both ways,
    the txns delivered and the server's metrics after each step."""
    net = Net()
    got = []
    net.server = quic.QuicServer(Sock(net, SRV), got.append,
                                 identity_seed=bytes(range(32)))
    steps = []

    def step(name):
        net.pump()
        steps.append((name, dict(net.server.metrics), len(got)))

    cli = quic.QuicClient(Sock(net, ("10.0.0.2", 9002)), SRV)
    cli.handshake(timeout=1)
    step("handshake")
    txns = make_signed_txns(6, seed=22)
    for t in txns:
        cli.send_txn(t)
    step("txns")
    # a multi-packet stream whose packets arrive last first
    big = bytes(range(256)) * 12
    mark = len(net.q[SRV])
    cli.send_txn(big)
    net.q[SRV].extend([net.q[SRV].pop()
                       for _ in range(len(net.q[SRV]) - mark)])
    step("out of order")
    assert cli.recv_acks(64) >= 7
    # garbage: a long header of noise, a short header of noise, and an
    # Initial under another connection's keys
    sock = Sock(net, ("10.0.0.3", 9003))
    sock.sendto(b"\xff" + stream(1)(40), SRV)
    sock.sendto(stream(2)(200), SRV)
    ck = quic.initial_keys(stream(3)(8))[0]
    sock.sendto(quic.seal_long(ck, quic.PT_INITIAL, stream(4)(8), b"\x02" * 8,
                               0, quic.enc_crypto_frame(0, b"x" * 32)), SRV)
    step("garbage")
    # a replay of a stream datagram the server took
    frame = quic.enc_stream_frame(cli.next_stream, 0, b"once", True)
    pkt = quic.seal_short(cli.c1rtt, cli.dcid, cli.tx_pn, frame)
    cli.tx_pn += 1
    cli.next_stream += 4
    for _ in range(3):
        sock.sendto(pkt, SRV)
    step("replay")
    # a stream that never FINs, past the reassembly cap
    for i in range(60):
        f = quic.enc_stream_frame(cli.next_stream, i * 1200,
                                  b"z" * 1200, False)
        cli.sock.sendto(quic.seal_short(cli.c1rtt, cli.dcid, cli.tx_pn, f),
                        SRV)
        cli.tx_pn += 1
    cli.next_stream += 4
    step("never fin")
    # a forged Initial for the established connection's dcid
    ck = quic.initial_keys(cli.dcid)[0]
    sock.sendto(quic.seal_long(ck, quic.PT_INITIAL, cli.dcid, b"\x09" * 8, 9,
                               quic.enc_crypto_frame(0, b"\x02\x00\x00\x04"
                                                     b"evil")), SRV)
    cli.send_txn(b"after the forged Initial")
    step("forged initial")
    # a second client that withholds its Finished: its 1-RTT data is
    # refused
    c2 = quic.QuicClient(Sock(net, ("10.0.0.4", 9004)), SRV)
    c2.tls.start()
    _, ch = c2.tls.emit.pop(0)
    hello = quic.enc_crypto_frame(0, ch)
    hello += bytes(max(0, 1162 - len(hello)))
    c2.sock.sendto(quic.seal_long(c2.ckeys, quic.PT_INITIAL, c2.dcid,
                                  c2.scid, 0, hello), SRV)
    net.pump()
    data, _ = c2.sock.recvfrom(4096)
    off = 0
    while off < len(data):
        chunk = data[off:]
        keys = c2.skeys if (chunk[0] >> 4) & 3 == quic.PT_INITIAL \
            else c2.shs
        ptype, _, _, payload, used = quic.open_long(keys, chunk)
        off += used
        lvl = 0 if ptype == quic.PT_INITIAL else 1
        for ft, f in quic.parse_frames(payload):
            if ft == quic.FRAME_CRYPTO:
                c2.cbuf[lvl].add(f["offset"], f["data"])
                c2.tls.on_crypto(lvl, c2.cbuf[lvl].drain())
        if c2.tls.sched.s_hs is not None and c2.shs is None:
            c2.chs = quic.Keys(c2.tls.sched.c_hs)
            c2.shs = quic.Keys(c2.tls.sched.s_hs)
    c2.tls.emit.clear()
    c2.c1rtt = quic.Keys(c2.tls.sched.c_ap)
    c2.send_txn(b"premature")
    step("withheld finished")
    return {"log": net.log, "steps": steps, "got": got,
            "conns": sorted(net.server.conns),
            "cert": net.server._cert()}


def test_server_and_client_equal_reference_under_one_entropy(monkeypatch):
    monkeypatch.setattr(os, "urandom", stream(9000))
    ref = _session(jq)
    monkeypatch.setattr(os, "urandom", stream(9000))
    port = _session(tq)
    assert len(port["log"]) == len(ref["log"])
    for i, (a, b) in enumerate(zip(ref["log"], port["log"])):
        assert a == b, f"datagram {i}"
    assert port == ref
    steps = {name: (m, n) for name, m, n in ref["steps"]}
    assert steps["txns"][1] == 6 and steps["out of order"][1] == 7
    assert steps["garbage"][0]["bad_pkts"] == 3
    assert steps["replay"][0]["replayed"] == 2
    assert steps["replay"][1] == steps["forged initial"][1] - 1 == 8
    assert steps["never fin"][0]["bad_pkts"] > 3
    assert steps["withheld finished"][1] == 9
    assert steps["withheld finished"][0]["bad_pkts"] > \
        steps["forged initial"][0]["bad_pkts"]
    assert len(ref["conns"]) == 2
    assert ref["cert"] == ttls.make_cert(bytes(range(32)))


# -- the reference's own tests, in lockstep ----------------------------------

# every in-process case; the ALPN case drives only the reference's
# TlsServer, so its counterpart below runs both packages'
LOCKSTEP = sorted(
    n for n in vars(test_quic) if n.startswith("test_")
    and n not in ("test_quic_tile_feeds_verify_topology",
                  "test_server_requires_tpu_alpn"))


@pytest.mark.parametrize("case", LOCKSTEP)
def test_reference_cases_match(monkeypatch, case):
    fn = getattr(test_quic, case)
    recs = []
    for root in ROOTS:
        monkeypatch.setattr(os, "urandom", stream(len(case)))
        recs.append(run_on(fn, {"quic": "waltz.quic"}, root)[0])
    assert recs[0] == recs[1]


def test_server_requires_tpu_alpn_on_both():
    outs = []
    for tls in (jtls, ttls):
        ch = tls.build_client_hello(bytes(range(32)), tls.x25519.pubkey(
            bytes(range(1, 33))), b"")
        body = ch[4:]
        off = 2 + 32
        off += 1 + body[off]
        off += 2 + struct.unpack_from(">H", body, off)[0]
        off += 1 + body[off]
        ext_len = struct.unpack_from(">H", body, off)[0]
        exts, keep, e = body[off + 2:off + 2 + ext_len], b"", 0
        while e < len(exts):
            et, ln = struct.unpack_from(">HH", exts, e)
            if et != tls.EXT_ALPN:
                keep += exts[e:e + 4 + ln]
            e += 4 + ln
        nb = body[:off] + struct.pack(">H", len(keep)) + keep
        srv = tls.TlsServer(bytes(32))
        with pytest.raises(tls.TlsError, match="no_application_protocol"):
            srv.on_crypto(tls.EL_INITIAL, bytes([tls.HT_CLIENT_HELLO])
                          + len(nb).to_bytes(3, "big") + nb)
        outs.append((ch, srv.alert, srv.alpn_ok))
    assert outs[0] == outs[1]


# -- the tiles ---------------------------------------------------------------

@pytest.fixture
def clock(monkeypatch):
    now = [10 * 1_000_000_000]
    for mod in (rshed, tshed):
        monkeypatch.setattr(mod, "monotonic_ns", lambda: now[0])
    return now


def _frags(ring) -> list:
    out, seq = [], 0
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out
        out.append(bytes(ring.payload(frag)))
        seq += 1


def _rig(rt, cls, name, **kw):
    w = rt.Workspace(f"/fdtt_q{name}_{os.getpid()}", 1 << 22)
    out = rt.Ring.create(w, depth=64, mtu=1280)
    return w, out, cls(out, [], port=0, batch=16, **kw)


def test_malformed_flood_on_both_tiles(clock):
    """tests/test_flood.py:417-437 on both QuicTiles: the garbage dies as
    bad_pkts, no txn frag, the Sybil sources inside the peer table."""
    frames = tchaos.attack_frames("flood_malformed_quic", 48, seed=13)
    got = []
    for rt, cls, name in ((jrt, RefQuicTile, "r"), (trt, QuicTile, "t")):
        w, out, tile = _rig(rt, cls, name,
                            shed={"rate_pps": 1000.0, "max_peers": 8})
        try:
            for i, f in enumerate(frames):
                clock[0] += 100_000
                tile.inject(f, (f"203.0.113.{i % 32 + 1}", 4000 + i))
            tile.poll_once()
            m = dict(tile.metrics)
            m.pop("port")
            got.append((m, _frags(out)))
        finally:
            tile.close()
            w.close()
            w.unlink()
    assert got[0] == got[1]
    m, frags = got[1]
    assert m["txns"] == 0 and frags == [] and m["peers"] <= 8
    assert m["bad_pkts"] + m["shed"] == 48 and m["bad_pkts"] > 0


def test_txns_on_both_tiles(monkeypatch):
    """A client's handshake and txns (and a forged-key Initial) into each
    package's QuicTile over localhost: the same frags, the same metrics."""
    txns = make_signed_txns(12, seed=31)
    got = []
    for rt, cls, name in ((jrt, RefQuicTile, "r"), (trt, QuicTile, "t")):
        monkeypatch.setattr(os, "urandom", stream(417))
        w, out, tile = _rig(rt, cls, name)
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                if not tile.poll_once():
                    time.sleep(0.001)
        th = threading.Thread(target=poll, daemon=True)
        th.start()
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        try:
            quic = jq if cls is RefQuicTile else tq
            cli = quic.QuicClient(s, ("127.0.0.1", tile.metrics["port"]))
            cli.handshake(timeout=10)
            time.sleep(0.05)             # the client Finished first
            for t in txns:
                cli.send_txn(t)
            s.sendto(b"\x40" + bytes(60), ("127.0.0.1",
                                           tile.metrics["port"]))
            deadline = time.time() + 10
            while tile.metrics["txns"] < len(txns) \
                    or tile.metrics["bad_pkts"] < 1:
                assert time.time() < deadline, tile.metrics
                time.sleep(0.01)
        finally:
            stop.set()
            th.join(timeout=10)
            assert not th.is_alive()
            m = dict(tile.metrics)
            m.pop("port")
            got.append((m, _frags(out)))
            tile.close()
            s.close()
            w.close()
            w.unlink()
    assert got[0] == got[1]
    m, frags = got[1]
    assert frags == txns and m["conns"] == 1 and m["bad_pkts"] == 1
    assert m["rx"] == 2 + len(txns) + 1


def test_adapter_takes_the_chaos_flood():
    """QuicAdapter's on_chaos pushes the plan's frames through the
    policed rx path from TEST-NET-3 sources, as the reference's."""
    from firedancer_tpu.disco.tiles import QuicAdapter as JQuicAdapter
    from firedancer_tpu_torch.disco.tiles import QuicAdapter
    got = []
    for rt, cls, name in ((jrt, JQuicAdapter, "r"), (trt, QuicAdapter,
                                                      "t")):
        w = rt.Workspace(f"/fdtt_qa{name}_{os.getpid()}", 1 << 22)
        out = rt.Ring.create(w, depth=64, mtu=1280)

        class Ctx:
            tile_name = "quic"
            out_rings = {"quic_verify": out}
            out_fseqs = {"quic_verify": []}
            plan = {"links": {"quic_verify": {"mtu": 1280}},
                    "shed": {"max_peers": 16}}
        a = cls(Ctx(), {"mtu": 9000, "batch": 8})
        try:
            assert a.tile.mtu == 1280
            a.on_chaos({"action": "flood_malformed_quic", "frames": 64,
                        "seed": 5})
            a.on_chaos({"action": "flood_forged", "frames": 4, "seed": 5})
            a.poll_once()
            m = a.metrics_items()
            m.pop("port")
            got.append((m, sorted(a.tile.shed.peers), _frags(out)))
        finally:
            a.on_halt()
            w.close()
            w.unlink()
    assert got[0] == got[1]
    m, peers, frags = got[1]
    assert m["bad_pkts"] + m["shed"] == 64 and m["txns"] == 0 and not frags
    assert len(peers) <= 16 and all(p.startswith("203.0.113.")
                                    for p in peers)
    assert set(QuicAdapter.METRICS) == set(JQuicAdapter.METRICS)
    assert QuicAdapter.GAUGES == JQuicAdapter.GAUGES


# -- cfg/quic.toml -----------------------------------------------------------

def test_quic_toml_boots_on_the_cpu():
    """cfg/quic.toml as four tile processes, verify on the CPU at batch
    16 (tests/test_quic.py:134 runs the reference's so), its [shed]
    policy as shipped: 24 valid txns and 4 with a flipped signature byte
    over one QUIC connection, paced under the policy's 300 datagrams/s
    and 8-deep bucket (groups of 4, each once the door has taken the
    last and 30 ms have refilled the bucket, so a door process the CPU
    left waiting never reads more than a bucket's worth at once); the
    sink gets the 24, verify fails the 4, one connection, nothing shed,
    every tile exits 0."""
    from firedancer_tpu_torch.app.config import build_topology, load_config
    from firedancer_tpu_torch.disco.launch import TopologyRunner
    cfg = load_config(QUIC_TOML, overrides={
        "tile": [{"name": "verify", "device": "cpu", "batch": 16}]})
    assert cfg["shed"]["rate_pps"] == 300 and cfg["shed"]["burst"] == 8
    runner = TopologyRunner(build_topology(
        cfg, name=f"tqc{os.getpid()}").build())
    txns = make_signed_txns(28, seed=5)
    forged = [t[:1 + i] + bytes([t[1 + i] ^ 1]) + t[2 + i:]
              for i, t in enumerate(txns[24:])]
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    try:
        runner.start()
        runner.wait_running(timeout_s=240)
        port = int(runner.metrics("quic")["port"])
        assert port
        cli = tq.QuicClient(s, ("127.0.0.1", port))
        cli.handshake(timeout=30)
        time.sleep(0.2)                  # the client Finished first
        sent = txns[:24] + forged
        for i in range(0, len(sent), 4):
            for t in sent[i:i + 4]:
                cli.send_txn(t)
            deadline = time.time() + 60
            while runner.metrics("quic")["txns"] < i + len(sent[i:i + 4]):
                assert time.time() < deadline, runner.metrics("quic")
                time.sleep(0.005)
            time.sleep(0.03)
        runner.wait_idle("sink", "rx", 24, timeout_s=120, poll_s=0.01)
        deadline = time.time() + 60
        while runner.metrics("verify")["verify_fail"] < 4:
            assert time.time() < deadline, runner.metrics("verify")
            time.sleep(0.05)
        q, v = runner.metrics("quic"), runner.metrics("verify")
        assert runner.metrics("sink")["rx"] == 24
        assert v["verify_fail"] == 4 and v["parse_fail"] == 0
        assert v["cpu_fallback"] == 0 and v["device_errors"] == 0
        assert q["conns"] == 1 and q["txns"] == 28 and q["bad_pkts"] == 0
        assert q["dropped"] == q["oversz"] == q["shed"] == 0
        runner.halt()
        assert all(p.exitcode == 0 for p in runner.procs.values())
    finally:
        runner.halt()
        runner.close()
        s.close()
