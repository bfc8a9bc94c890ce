"""The port's SockTile against the reference's over real localhost UDP
sockets: each scenario of tests/test_flood.py's sock door (the batch
grain, drop-newest under a shed flood, the staked waiting room) sends
the same datagrams from the same sockets to both tiles and polls them in
lockstep under one fake clock (the policy's token buckets and overload
hold read it), each tile over its own package's shm ring. At every
checkpoint the out rings' bytes, the metrics (less the bound `port`) and
the waiting room must be equal. Host code only: exact."""
import os
import socket
import time

import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.disco import shed as rshed
from firedancer_tpu.tiles.sock import SockTile as RefSockTile
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.disco import shed as tshed
from firedancer_tpu_torch.tiles.sock import SockTile

MS = 1_000_000


@pytest.fixture
def clock(monkeypatch):
    now = [10 * 1_000_000_000]
    for mod in (rshed, tshed):
        monkeypatch.setattr(mod, "monotonic_ns", lambda: now[0])
    return now


class Rig:
    def __init__(self, rt, tile_cls, depth, **kw):
        self.w = rt.Workspace(f"/fdtt_sk{id(self)}_{os.getpid()}", 1 << 22)
        self.out = rt.Ring.create(self.w, depth=depth, mtu=512)
        self.fseq = rt.Fseq(self.w)
        self.tile = tile_cls(self.out, [self.fseq], port=0, **kw)

    def snap(self):
        m = dict(self.tile.metrics)
        m.pop("port")
        out, seq = [], max(0, self.out.seq - self.out.depth)
        while True:
            rc, frag = self.out.consume(seq)
            if rc != 0:
                break
            out.append(bytes(self.out.payload(frag)))
            seq += 1
        return m, [bytes(d) for d, _ in self.tile._staked_hold], out

    def close(self):
        self.tile.close()
        self.w.close()
        self.w.unlink()


class Pair:
    """The reference's tile and the port's, driven in lockstep."""

    def __init__(self, clock, depth, **kw):
        self.clock = clock
        self.rigs = [Rig(jrt, RefSockTile, depth, **kw),
                     Rig(trt, SockTile, depth, **kw)]

    def send(self, sock, payload):
        for r in self.rigs:
            sock.sendto(payload, ("127.0.0.1", r.tile.port))

    def poll(self, n, step=MS):
        time.sleep(0.05)           # loopback delivery into both buffers
        for _ in range(n):
            self.clock[0] += step
            for r in self.rigs:
                r.tile.poll_once()

    def update(self, seq):
        for r in self.rigs:
            r.fseq.update(seq)

    def check(self):
        ref, port = (r.snap() for r in self.rigs)
        assert port == ref
        return port

    def close(self):
        for r in self.rigs:
            r.close()


def _bound(n=1):
    out = []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        out.append(s)
    return out


def test_batch_grain_bytes_exact_and_credit_bounded(clock):
    """One publish_batch a poll, jumbos dropped, and with no shed
    policy a full ring leaves datagrams in the kernel buffer."""
    p = Pair(clock, depth=8, batch=16, mtu=256)
    (tx,) = _bound()
    try:
        frames = [bytes([i]) * (20 + i) for i in range(6)]
        for f in frames:
            p.send(tx, f)
        p.send(tx, b"J" * 300)
        p.poll(3)
        m, _, out = p.check()
        assert m["rx"] == 6 and m["oversz"] == 1 and out == frames
        for i in range(12):
            p.send(tx, b"q%d" % i)
        p.poll(3)
        m, _, _ = p.check()
        assert m["rx"] == 8 and m["backpressure"] > 0
        p.update(6)
        p.poll(3)
        m, _, out = p.check()
        assert m["rx"] == 14 and out[-1] == b"q7"
    finally:
        p.close()
        tx.close()


def test_shed_flood_drops_newest_staked_lands(clock):
    """A full ring with the shed armed drains and drops hostile bursts,
    the Sybil table stays bounded, and a staked peer lands once credits
    return."""
    (staked,) = _bound()
    floods = _bound(20)
    skey = f"127.0.0.1:{staked.getsockname()[1]}"
    p = Pair(clock, depth=16, batch=16, mtu=256,
             shed={"rate_pps": 500.0, "burst": 4, "max_peers": 8,
                   "min_stake": 1, "overload_hold_s": 5.0,
                   "stakes": {skey: 1000}})
    try:
        for _ in range(8):
            for s in floods:
                p.send(s, b"x" * 64)
        p.poll(40)
        m, _, _ = p.check()
        assert m["shed"] > 0 and m["peers"] <= 8 and m["overload"] == 1
        for _ in range(4):
            for s in floods:
                p.send(s, b"y" * 64)
        p.poll(20)
        m2, _, _ = p.check()
        assert m2["rx"] == m["rx"] and m2["shed"] > m["shed"]
        p.update(16)
        for i in range(3):
            p.send(staked, b"staked-%d" % i)
        p.poll(5)
        m3, _, out = p.check()
        assert m3["rx"] == m["rx"] + 3
        assert out[-3:] == [b"staked-0", b"staked-1", b"staked-2"]
    finally:
        p.close()
        for s in [staked, *floods]:
            s.close()


def test_staked_waiting_room_survives_full_door(clock):
    """Staked datagrams caught in the full door's drain park in the
    bounded waiting room and re-enter first, in arrival order, when
    credits return; unstaked burst-mates are dropped newest."""
    staked, junk = _bound(2)
    skey = f"127.0.0.1:{staked.getsockname()[1]}"
    p = Pair(clock, depth=8, batch=8, mtu=256,
             shed={"rate_pps": 500.0, "burst": 16, "max_peers": 8,
                   "min_stake": 1, "overload_hold_s": 30.0,
                   "stakes": {skey: 1000}})
    try:
        for i in range(8):
            p.send(junk, b"fill-%d" % i)
        p.poll(10)
        m, _, _ = p.check()
        assert m["rx"] == 8
        for i in range(3):
            p.send(staked, b"held-%d" % i)
            p.send(junk, b"junk-%d" % i)
        p.poll(10)
        m, hold, _ = p.check()
        assert m["rx"] == 8 and hold == [b"held-0", b"held-1", b"held-2"]
        assert m["shed"] >= 3
        for i in range(16):
            p.send(staked, b"over-%d" % i)
        p.poll(20)
        _, hold, _ = p.check()
        assert len(hold) == 8
        p.update(8)
        p.poll(10)
        m, _, out = p.check()
        assert out[:3] == [b"held-0", b"held-1", b"held-2"]
        assert m["rx"] == 16
    finally:
        p.close()
        staked.close()
        junk.close()
