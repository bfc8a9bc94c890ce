"""QUIC client load for the quic door (cfg/quic.toml): worker processes,
each holding some of the client connections (waltz/quic.QuicClient over
one UDP socket a connection, one peer at the door each).

    load = QuicLoad(workers=4, conns=256).start()   # no torch
    hs = load.connect(("127.0.0.1", port))  # seconds, a handshake each
    load.send_async(txns, rate=None, window=16)    # one call a leg
    leg = load.wait_sent(poll)            # poll() runs meanwhile
    load.replay()       # resend one datagram the server already took
    load.ping(n, rate)  # 1-RTT PING packets: read by the door, no txn
    load.close()

A worker handshakes its connections one after another (the workers run
in parallel) and waits until each connection has the server's
HANDSHAKE_DONE, the proof that the server took the client Finished; a
Finished not answered in 2 s is sent again. `send_async` splits the txns
round-robin over the workers and each worker over its connections, one
txn a unidirectional stream (`QuicClient.send_txn`: one datagram for a
txn up to 1,232 bytes). The client never retransmits a stream, so a
worker keeps at most `window` stream datagrams between what it sent and
what the server acknowledged (the server sends one ACK a datagram that
carries a stream frame): the server's socket then never holds more than
`window` x workers of them, and the door is kept busy without a flood
that the socket would drop. With `rate`, the workers also pace their
sends at `rate / workers` each. A datagram the server never acknowledges
stalls the window; after `STALL_S` without an acknowledgement the worker
counts what it still waits for as `unacked` and goes on. A worker
process imports neither torch nor the JAX package (it reports
`torch_imported`). chip_smoke.py phase 26 drives cfg/quic.toml with
it."""
from __future__ import annotations

import collections
import multiprocessing as mp
import select
import socket
import sys
import time

STALL_S = 0.25        # no acknowledgement for this long: stop waiting
DONE_WAIT_S = 2.0     # for HANDSHAKE_DONE before the Finished is resent
HANDSHAKE_S = 10.0    # a handshake's limit, and each attempt's wait


class _Tap:
    """A client socket that keeps the last datagram sent."""

    def __init__(self, sock):
        self.sock = sock
        self.last = None

    def sendto(self, data, addr):
        self.last = data
        return self.sock.sendto(data, addr)

    def __getattr__(self, name):
        return getattr(self.sock, name)


class _Client:
    """A connection: its QuicClient, the pns of its stream datagrams the
    server has not acknowledged, and the last one it sent."""

    def __init__(self, addr):
        from ..waltz.quic import QuicClient
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        self.tap = _Tap(s)
        self.q = QuicClient(self.tap, addr)
        self.pending = collections.deque()
        self.acked = -1
        self.last = None           # (pn, datagram) of the last stream
        self.done = False          # HANDSHAKE_DONE seen

    def fileno(self):
        return self.tap.sock.fileno()

    def read(self) -> int:
        """Read every datagram waiting on the socket -> the stream
        datagrams acknowledged by them."""
        from ..waltz import quic
        n = 0
        while True:
            try:
                data, _ = self.tap.sock.recvfrom(2048)
            except OSError:
                return n
            try:
                pn, payload = quic.open_short(
                    self.q.s1rtt, data, len(self.q.scid), self.q.rx_largest)
            except (ValueError, IndexError):
                continue
            self.q.rx_largest = max(self.q.rx_largest, pn)
            for ft, f in quic.parse_frames(payload):
                if ft == quic.FRAME_HANDSHAKE_DONE:
                    self.done = True
                elif ft == quic.FRAME_ACK and f["largest"] > self.acked:
                    self.acked = f["largest"]
                    while self.pending and self.pending[0] <= self.acked:
                        self.pending.popleft()
                        n += 1

    def send(self, txn: bytes):
        pn = self.q.tx_pn
        self.q.send_txn(txn)
        self.pending.append(pn)
        self.last = (pn, self.tap.last)


def _handshake(c: _Client) -> float:
    t0 = time.perf_counter()
    c.q.handshake(timeout=HANDSHAKE_S)
    fin = c.tap.last
    c.tap.sock.setblocking(False)
    deadline = t0 + HANDSHAKE_S
    resend = time.perf_counter() + DONE_WAIT_S
    while not c.done:
        now = time.perf_counter()
        if now > deadline:
            raise TimeoutError("no HANDSHAKE_DONE from the server")
        if now > resend:
            c.tap.sock.sendto(fin, c.q.addr)
            resend = now + DONE_WAIT_S
        select.select([c], [], [], 0.01)
        c.read()
    return time.perf_counter() - t0


def _send(clients, txns, rate, window) -> dict:
    """One leg of a worker: txns round-robin over its clients."""
    t0 = time.perf_counter()
    inflight = acked = unacked = 0
    last_ack = t0
    i, step = 0, (1.0 / rate if rate else 0.0)
    due = t0
    while i < len(txns) or inflight:
        now = time.perf_counter()
        can = i < len(txns) and inflight < window
        if can and now >= due:
            clients[i % len(clients)].send(txns[i])
            i += 1
            inflight += 1
            due += step
            continue
        # read acknowledgements until the next send is due
        r, _, _ = select.select(clients, [], [],
                                min(due - now, 0.002) if can else 0.002)
        got = sum(c.read() for c in r)
        if got:
            acked += got
            inflight -= got
            last_ack = time.perf_counter()
        elif inflight and time.perf_counter() - last_ack > STALL_S:
            # what the server never acknowledged: lost at its socket,
            # or its ACK lost at ours
            for c in clients:
                unacked += len(c.pending)
                c.pending.clear()
            inflight = 0
            last_ack = time.perf_counter()
    return {"sent": len(txns), "acked": acked, "unacked": unacked,
            "s": time.perf_counter() - t0}


def _worker(pipe, n_conns: int):
    clients = []
    while True:
        cmd, *args = pipe.recv()
        if cmd == "connect":
            clients = [_Client(args[0]) for _ in range(n_conns)]
            hs = [_handshake(c) for c in clients]
            pipe.send({"handshake_s": hs,
                       "torch_imported": "torch" in sys.modules})
        elif cmd == "send":
            txns, rate, window = args
            pipe.send(_send(clients, txns, rate, window))
        elif cmd == "replay":
            # a stream datagram whose own pn the server acknowledged
            c = next(c for c in clients
                     if c.last is not None and c.last[0] == c.acked)
            c.tap.sock.sendto(c.last[1], c.q.addr)
            pipe.send(c.last[0])
        elif cmd == "ping":
            from ..waltz import quic
            n, rate = args
            t0 = time.perf_counter()
            for k in range(n):
                c = clients[k % len(clients)]
                pkt = quic.seal_short(c.q.c1rtt, c.q.dcid, c.q.tx_pn,
                                      bytes([quic.FRAME_PING]))
                c.q.tx_pn += 1
                c.tap.sock.sendto(pkt, c.q.addr)
                time.sleep(max(0.0, t0 + (k + 1) / rate
                               - time.perf_counter()))
            pipe.send(n)
        elif cmd == "close":
            for c in clients:
                c.tap.sock.close()
            pipe.send(None)
            return


class QuicLoad:
    """The parent's side: `workers` processes, `conns` connections in
    all (split evenly)."""

    def __init__(self, workers: int, conns: int):
        assert conns % workers == 0, (conns, workers)
        self.workers, self.conns = workers, conns
        self.pipes, self.procs = [], []

    def start(self) -> "QuicLoad":
        ctx = mp.get_context("spawn")
        for _ in range(self.workers):
            a, b = ctx.Pipe()
            p = ctx.Process(target=_worker,
                            args=(b, self.conns // self.workers), daemon=True)
            p.start()
            self.pipes.append(a)
            self.procs.append(p)
        return self

    def connect(self, addr) -> list:
        """Open every connection to the server at `addr` -> each
        handshake's seconds, HANDSHAKE_DONE included."""
        for pipe in self.pipes:
            pipe.send(("connect", addr))
        got = [pipe.recv() for pipe in self.pipes]
        assert not any(g["torch_imported"] for g in got), \
            "a QUIC load worker imported torch"
        return [s for g in got for s in g["handshake_s"]]

    def send_async(self, txns, rate: float | None = None,
                   window: int = 16):
        """Start one leg: every txn once, unpaced or at `rate` txns/s
        in all; `wait_sent` collects."""
        w = self.workers
        for k, pipe in enumerate(self.pipes):
            pipe.send(("send", txns[k::w], rate / w if rate else None,
                       window))

    def wait_sent(self, poll=None) -> dict:
        """Wait for every worker of `send_async`, calling `poll()` while
        any still sends -> the sums of the workers' records (sent, acked,
        unacked) and the slowest's seconds."""
        legs = [None] * self.workers
        while any(g is None for g in legs):
            for k, pipe in enumerate(self.pipes):
                if legs[k] is None and pipe.poll(0.01):
                    legs[k] = pipe.recv()
            if poll is not None and any(g is None for g in legs):
                poll()
        return {"sent": sum(g["sent"] for g in legs),
                "acked": sum(g["acked"] for g in legs),
                "unacked": sum(g["unacked"] for g in legs),
                "s": max(g["s"] for g in legs)}

    def replay(self) -> int:
        """Resend one stream datagram of worker 0 that the server took
        -> its pn."""
        self.pipes[0].send(("replay",))
        return self.pipes[0].recv()

    def ping(self, n: int, rate: float):
        """n PING packets from worker 0's connections at `rate`."""
        self.pipes[0].send(("ping", n, rate))
        self.pipes[0].recv()

    def close(self):
        for pipe, p in zip(self.pipes, self.procs):
            try:
                pipe.send(("close",))
                pipe.recv()
            except (OSError, EOFError):
                pass
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self.pipes, self.procs = [], []
