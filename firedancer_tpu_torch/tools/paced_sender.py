"""A paced UDP sender for the front door's drills (copy of the JAX
package's bench.py `_PacedSender`, bench.py:1082-1126).

    sender = PacedSender(frames, port, pps=80.0, sock=staked).start()
    ...
    sent = sender.stop()

One daemon thread sends `frames` round-robin (wrapping) at aggregate
`pps` to 127.0.0.1:`port`, rotating over one or more bound sockets, each
socket one peer identity at the door. A Sybil swarm is one sender over
`nsocks` sockets; `swarm` runs one in a worker process, so that several
of them reach a rate one interpreter's lock would cap. `WindowSender` is
the saturating form: it keeps a
fixed number of frames between what it sent and what the sink counted,
so the pipeline never starves and the door never overflows.
`staked_pool(n, seed)` signs n distinct valid txns, the same bytes as
tiles/synth.make_signed_txns(n, seed), with a fixed-base table for the
base-point products (some 20x faster than the reference signer).
chip_smoke.py phase 19c drives cfg/flood.toml with all three."""
from __future__ import annotations

import hashlib
import socket
import threading
import time

_COMB: list | None = None


def _comb() -> list:
    """rows[i][j] = j * 256**i * B (8-bit windows, 32 rows): a base-point
    product is then at most 32 additions."""
    global _COMB
    if _COMB is None:
        from ..utils.ed25519_ref import BASEPOINT, pt_add
        rows, base = [], BASEPOINT
        for _ in range(32):
            row = [None, base]
            for _ in range(254):
                row.append(pt_add(row[-1], base))
            rows.append(row)
            base = pt_add(row[-1], base)
        _COMB = rows
    return _COMB


def _base_mul(k: int):
    from ..utils.ed25519_ref import pt_add
    q = (0, 1, 1, 0)
    for row in _comb():
        if k & 255:
            q = pt_add(q, row[k & 255])
        k >>= 8
    return q


def comb_signer():
    """A `signer(seed_bytes, msg) -> (pub, sig)` for make_signed_txns:
    RFC 8032 signing as utils/ed25519_ref.sign, each key expanded once."""
    from ..utils.ed25519_ref import L, pt_compress
    keys: dict = {}

    def signer(seed: bytes, msg: bytes):
        key = keys.get(seed)
        if key is None:
            h = hashlib.sha512(seed).digest()
            a = int.from_bytes(h[:32], "little")
            a = (a & ((1 << 254) - 8)) | (1 << 254)
            key = keys[seed] = (a, h[32:], pt_compress(_base_mul(a)))
        a, prefix, pub = key
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(),
                           "little") % L
        rb = pt_compress(_base_mul(r))
        k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(),
                           "little") % L
        return pub, rb + ((r + k * a) % L).to_bytes(32, "little")
    return signer


def staked_pool(n: int, seed: int) -> list[bytes]:
    """n distinct valid txns: make_signed_txns(n, seed)'s bytes."""
    from ..tiles.synth import make_signed_txns
    return make_signed_txns(n, seed, signer=comb_signer())


class PacedSender:
    """Daemon thread pacing datagrams at aggregate `pps`, rotating
    round-robin over one or more bound sockets (each socket = one peer
    identity at the door). The staked client is a single socket; the
    Sybil swarm is ONE thread over `nsocks` sockets — same identities
    and aggregate rate as a thread per Sybil, without handing the
    scheduler dozens of competing sender threads."""

    def __init__(self, frames: list, port: int, pps: float,
                 sock=None, nsocks: int = 1):
        if sock is not None:
            self.socks = [sock]
        else:
            self.socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                          for _ in range(nsocks)]
        self.frames, self.port, self.pps = frames, port, pps
        self.sent = 0
        self._stop = threading.Event()
        self._thr = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thr.start()
        return self

    def _run(self):
        t0 = time.perf_counter()
        while not self._stop.is_set():
            budget = int((time.perf_counter() - t0) * self.pps)
            while self.sent < budget and not self._stop.is_set():
                self.socks[self.sent % len(self.socks)].sendto(
                    self.frames[self.sent % len(self.frames)],
                    ("127.0.0.1", self.port))
                self.sent += 1
            time.sleep(0.002)

    def stop(self) -> int:
        """Stop sending, close the sockets; -> datagrams sent."""
        self._stop.set()
        self._thr.join(timeout=5)
        for s in self.socks:
            s.close()
        return self.sent


def swarm(frames: list, port: int, pps: float, nsocks: int,
          seconds: float) -> tuple[int, float]:
    """A PacedSender over `nsocks` sockets for `seconds` (a worker
    process's job) -> (datagrams sent, seconds it sent for)."""
    p = PacedSender(frames, port, pps, nsocks=nsocks)
    t0 = time.perf_counter()
    p.start()
    time.sleep(seconds)
    t1 = time.perf_counter()
    return p.stop(), t1 - t0


class WindowSender:
    """The saturating sender: one daemon thread sends `frames` in order
    from one socket, keeping `window` of them between what it sent and
    `counted()` (the sink's rx), so the ring ahead of the slowest tile
    stays full without overflowing the door. It stops when the frames
    run out (`dry`)."""

    def __init__(self, frames: list, port: int, counted, window: int,
                 sock=None):
        self.sock = sock if sock is not None else \
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.frames, self.port = frames, port
        self.counted, self.window = counted, window
        self.sent = 0
        self._stop = threading.Event()
        self._thr = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thr.start()
        return self

    @property
    def dry(self) -> bool:
        return self.sent >= len(self.frames)

    def _run(self):
        while not self._stop.is_set() and not self.dry:
            room = min(self.window - (self.sent - self.counted()),
                       len(self.frames) - self.sent)
            for _ in range(max(0, room)):
                self.sock.sendto(self.frames[self.sent],
                                 ("127.0.0.1", self.port))
                self.sent += 1
            time.sleep(0.0005)

    def stop(self) -> int:
        """Stop sending, close the socket; -> datagrams sent."""
        self._stop.set()
        self._thr.join(timeout=5)
        self.sock.close()
        return self.sent
