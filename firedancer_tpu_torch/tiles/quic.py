"""QUIC ingest tile core: datagrams -> QUIC server -> txn frags (copy of
the JAX package's tiles/quic.py: the same frags and metrics for the same
datagrams).

The fd_quic_tile analog (ref: src/disco/quic/fd_quic_tile.c:234,303:
completed TPU streams publish into the verify ring through
fd_tpu_reasm_publish_fast). The socket is nonblocking; each poll drains
a burst of datagrams through the QUIC server (waltz/quic.py), and every
completed unidirectional stream publishes one txn frag downstream. The
door touches no device: the verify tile behind it runs the kernels.

Front-door policing: with a `shed` table configured (disco/shed.py),
every datagram's source address is policed BEFORE the QUIC server spends
decrypt and parse work on it (the reference's stance: connection quotas
ahead of the TPU reasm, src/waltz/quic/). Under backpressure with the
shed armed, the tile trips overload and drain-and-drops a burst
(drop-newest at the door, the sock tile's discipline), so a flood never
ages in the kernel queue and never wedges the ring. A txn frag that
finds no credit waits at most 5 ms and is then dropped (`dropped`); one
longer than `mtu` is dropped as `oversz`. The client never retransmits a
stream, so a dropped txn is gone.
"""
from __future__ import annotations

import socket
import time

from ..waltz.quic import QuicServer


class QuicTile:
    def __init__(self, out_ring, out_fseqs, port: int = 0,
                 bind_addr: str = "127.0.0.1", batch: int = 64,
                 mtu: int = 1500, shed: dict | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind_addr, port))
        self.sock.setblocking(False)
        self.out = out_ring
        self.out_fseqs = out_fseqs
        self.batch = batch
        self.mtu = mtu
        self._seq = 0
        self.shed = None
        if shed is not None:
            from ..disco.shed import PeerGate
            self.shed = PeerGate(shed)

        def on_txn(payload: bytes):
            if len(payload) > self.mtu:
                self.metrics["oversz"] += 1
                return
            # bounded wait, then DROP (the client's loss recovery
            # re-sends; an unbounded spin would deadlock halt() when
            # the consumer dies — the sock tile's discipline)
            deadline = time.monotonic() + 0.005
            while self.out_fseqs and \
                    self.out.credits(self.out_fseqs) <= 0:
                self.metrics["backpressure"] += 1
                if time.monotonic() > deadline:
                    self.metrics["dropped"] += 1
                    return
                time.sleep(20e-6)
            self.out.publish(payload, sig=self._seq)
            self._seq += 1

        self.server = QuicServer(self.sock, on_txn)
        self.metrics = {"rx": 0, "txns": 0, "conns": 0, "bad_pkts": 0,
                        "oversz": 0, "backpressure": 0, "dropped": 0,
                        "replayed": 0, "shed": 0, "shed_unstaked": 0,
                        "peers": 0, "overload": 0, "port": 0}
        self.metrics["port"] = self.sock.getsockname()[1]

    def _shed_counters(self):
        if self.shed is not None:
            self.metrics.update(self.shed.counters())

    def inject(self, data: bytes, addr) -> bool:
        """One datagram through the policed rx path (shared by the
        socket drain and the chaos traffic injector): shed first, THEN
        decrypt/parse — hostile bytes die before they cost anything."""
        if self.shed is not None and not self.shed.admit(addr):
            return False           # gate counters carry the shed tick
        self.server.on_datagram(data, addr)
        return True

    def poll_once(self) -> int:
        credits = self.out.credits(self.out_fseqs) if self.out_fseqs \
            else self.batch
        if self.shed is not None and self.out_fseqs \
                and credits <= self.out.depth // 2:
            # early watermark (the sock tile's rule): shed unstaked
            # while there is still room for staked
            self.shed.trip_overload()
        if self.out_fseqs and credits <= 0:
            self.metrics["backpressure"] += 1
            if self.shed is None:
                # leave datagrams in the kernel buffer while downstream
                # has no credits (don't decrypt work we'd have to drop)
                return 0
            # shed armed: trip overload and drain-and-drop a burst so
            # a flood never ages in the kernel queue (drop-newest at
            # the door, never a ring wait — the sock tile's contract)
            self.shed.trip_overload()
            for _ in range(self.batch):
                try:
                    _, addr = self.sock.recvfrom(2048)
                except OSError:
                    break
                self.shed.count_drop(addr)
            self._shed_counters()
            return 0
        n = 0
        for _ in range(self.batch):
            try:
                data, addr = self.sock.recvfrom(2048)
            except OSError:
                break
            self.inject(data, addr)
            n += 1
        m = self.server.metrics
        self.metrics.update(rx=m["pkts"], txns=m["txns"],
                            conns=m["conns"], bad_pkts=m["bad_pkts"],
                            replayed=m["replayed"])
        self._shed_counters()
        return n

    def close(self):
        self.sock.close()
