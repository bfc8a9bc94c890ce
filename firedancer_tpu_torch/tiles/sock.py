"""UDP socket ingest tile — the net-tile fallback path (copy of the JAX
package's tiles/sock.py: host code, the reference's behaviour byte for
byte).

The reference's ingress ladder is XDP (kernel-bypass) with a plain
socket fallback (ref: src/disco/net/sock/fd_sock_tile.c:1-35 — batched
recvmmsg into ring frags, the same frag contract as the XDP tile). This
tile is the socket rung re-expressed for the shm ring runtime: a
non-blocking bound UDP socket drained in bursts straight into the out
ring, with ring credits as backpressure.

Batched egress: the whole drained burst lands in one padded rx buffer
and ships as ONE credit-gated `publish_batch` per poll — the
recvmmsg-into-frags grain of the reference, no per-datagram Python
publish.

Front-door policing: with a `shed` table configured
(disco/shed.py — per-peer token buckets, bounded peer table,
stake-weighted overload shedding), every datagram's source address is
policed BEFORE it costs a ring slot. Overload semantics are
deterministic:

  * credits available: drain up to min(batch, credits) datagrams,
    shed rate-violators and (while overloaded) unstaked peers at the
    door, publish the survivors as one batch. Admitted rows are
    bounded by credits, so the batch cannot stall mid-way against a
    live consumer; a row the ring still refuses (rewound fseq) is
    dropped-newest, never spun on.
  * no credits, no shed policy: leave datagrams in the kernel socket
    buffer (the kernel is the overflow queue — the seed behavior).
  * no credits, shed policy armed: trip overload and DRAIN-AND-DROP a
    burst (drop-newest at the door) so the kernel queue never grows a
    stale flood backlog; the ring is never wedged, memory never grows,
    and when pressure clears the overload hold expires on its own.
    STAKED datagrams caught in the drained burst park in a bounded
    waiting room (<= batch frames) and re-enter through the normal
    admission gate when credits return — a garbage burst saturating
    the ring must not take the staked trickle down with it.

QUIC TPU ingest (src/waltz/quic/) terminates streams above this layer;
this tile is the plain datagram door the bench harness uses, and the
port's QUIC door is tiles/quic.py, which binds its own socket.
"""
from __future__ import annotations

import errno
import socket

import numpy as np


class SockTile:
    def __init__(self, out_ring, out_fseqs, port: int = 0,
                 bind_addr: str = "127.0.0.1", batch: int = 64,
                 mtu: int = 1500, shed: dict | None = None):
        self.out = out_ring
        self.out_fseqs = out_fseqs
        self.batch = batch
        self.mtu = mtu
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
        self.sock.bind((bind_addr, port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.shed = None
        if shed is not None:
            from ..disco.shed import PeerGate
            self.shed = PeerGate(shed)
        # staked waiting room: when the full door drain-and-drops, the
        # few STAKED datagrams caught in the burst park here (bounded
        # at `batch` frames — O(batch*mtu) memory whatever the flood
        # does) and re-enter through the normal admission gate when
        # credits return. Drop-newest stays the rule for everyone
        # past the bound; this just keeps a garbage burst from taking
        # the staked trickle down with it (the reference's
        # stake-priority stance, fd_stake-weighted quic quotas).
        self._staked_hold: list = []
        # one rx staging buffer reused every poll: the burst is padded
        # rows + sizes, published as a single native batch call
        self._rxbuf = np.zeros((batch, mtu), np.uint8)
        self._rxsz = np.zeros(batch, np.uint32)
        self.metrics = {"rx": 0, "bytes": 0, "oversz": 0,
                        "backpressure": 0, "shed": 0,
                        "shed_unstaked": 0, "shed_overflow": 0,
                        "peers": 0, "overload": 0, "port": self.port}

    def _recv(self):
        try:
            return self.sock.recvfrom(self.mtu + 1)
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return None
            raise

    def _shed_counters(self):
        if self.shed is not None:
            self.metrics.update(self.shed.counters())

    def poll_once(self) -> int:
        credits = self.out.credits(self.out_fseqs) if self.out_fseqs \
            else self.batch
        if self.shed is not None and self.out_fseqs \
                and credits <= self.out.depth // 2:
            # early watermark: the ring is half full, so ingest is
            # outrunning the pipeline — start shedding unstaked NOW,
            # before saturation forces drop-newest on everyone (the
            # stake-weighted half of the overload contract only helps
            # if it engages while there is still room for staked)
            self.shed.trip_overload()
        if credits <= 0:
            self.metrics["backpressure"] += 1
            if self.shed is None:
                return 0          # kernel socket buffer = overflow queue
            # overload: the ring is full, so everything arriving now is
            # drop-newest at the door — drain a burst and shed it all
            # (unstaked counted separately) instead of letting a flood
            # age in the kernel queue; the ring is never waited on
            self.shed.trip_overload()
            for _ in range(self.batch):
                pkt = self._recv()
                if pkt is None:
                    break
                if len(pkt[0]) <= self.mtu \
                        and self.shed.is_staked(pkt[1]) \
                        and len(self._staked_hold) < self.batch:
                    self._staked_hold.append(pkt)
                else:
                    self.shed.count_drop(pkt[1])
            self._shed_counters()
            return 0
        k = 0
        want = min(self.batch, credits)
        while k < want:
            if self._staked_hold:
                # parked staked traffic re-enters FIRST, through the
                # same admission gate as fresh arrivals (its token
                # bucket still meters it)
                data, addr = self._staked_hold.pop(0)
            else:
                pkt = self._recv()
                if pkt is None:
                    break
                data, addr = pkt
            if len(data) > self.mtu:
                self.metrics["oversz"] += 1     # jumbo: drop, don't trunc
                continue
            if self.shed is not None and not self.shed.admit(addr):
                continue           # gate counters carry the shed tick
            self._rxbuf[k, :len(data)] = np.frombuffer(data, np.uint8)
            self._rxsz[k] = len(data)
            k += 1
        if not k:
            if self.shed is not None:
                self._shed_counters()
            return 0
        sigs = np.arange(self.metrics["rx"], self.metrics["rx"] + k,
                         dtype=np.uint64)
        stop, pub = self.out.publish_batch(
            self._rxbuf[:k], self._rxsz[:k], sigs,
            np.ones(k, np.uint8), fseqs=self.out_fseqs)
        if pub < k:
            # rows bounded by the credit pre-check, so a short publish
            # means a consumer rewound mid-poll: drop-newest, count it,
            # and let the overload hold shed the next bursts cheaper
            self.metrics["shed_overflow"] += k - pub
            if self.shed is not None:
                self.shed.trip_overload()
        self.metrics["rx"] += pub
        self.metrics["bytes"] += int(self._rxsz[:pub].sum())
        self._shed_counters()
        return pub

    def close(self):
        self.sock.close()
