"""Repair tile core: the shred request/response protocol over UDP
(copy of the JAX package's tiles/repair.py).

The reference's repair tile (ref: src/discof/repair/fd_repair_tile.c:1-15)
watches the shred stream for gaps (forest), plans signed requests
(policy, keyguard REPAIR role), sends them to peers, serves peers'
requests from its own shred store, and forwards repair responses back
into the FEC resolver. This core drives the already-tested libraries
(repair/forest.py, repair/policy.py) behind the ring ABI; both the
client and server halves share one UDP socket, exactly like the
reference's single repair port.

Wire formats:
  request  = policy.pack_request payload (96B) + ed25519 sig (64B),
             signed by the sender's identity via the keyguard
  response = the raw shred wire, verbatim (the merkle proof + leader
             signature authenticate it downstream in the FEC resolver,
             so the response needs no extra envelope)
"""
from __future__ import annotations

import time

from ..repair.forest import Forest
from ..repair.policy import (
    DISC_ANCESTOR_HASHES, DISC_HIGHEST_WINDOW, DISC_ORPHAN,
    DISC_WINDOW_INDEX, REQ_LEN, RepairPolicy, parse_request,
)
from ..shred import format as fmt
from ..utils.ed25519_ref import verify

RESP_MAX = fmt.SHRED_MAX_SZ


class RepairCore:
    def __init__(self, identity: bytes, sign_fn, sock,
                 peers: list[tuple[bytes, tuple]] = (),
                 root_slot: int | None = None, out_ring=None,
                 out_fseqs=None, serve_slots: int = 512,
                 max_requests: int = 32, shed: dict | None = None):
        """peers: [(pubkey, (host, port))]. sign_fn(payload)->sig|None
        (keyguard REPAIR role). out_ring: repaired shred wires toward
        the FEC resolver. root_slot=None anchors the forest at the
        FIRST observed shred's parent — a node attaching mid-stream
        must not walk repair backward to genesis (the reference anchors
        at the snapshot slot). shed: effective policing table
        (disco/shed.py) — the repair port is an internet-facing door
        too: every datagram (request or response) pays one admission
        before the signature verify / shred parse runs, and out-ring
        backpressure trips stake-weighted overload shedding."""
        self.identity = identity
        self.sign_fn = sign_fn
        self.sock = sock
        if shed is not None:
            from ..disco.shed import PeerGate
            self.shed = PeerGate(shed)
        else:
            self.shed = None
        self.forest = Forest(root_slot if root_slot is not None else 0)
        self._auto_anchor = root_slot is None
        self.policy = RepairPolicy(identity)
        self.policy.set_peers([p for p, _ in peers])
        self.addr_of = {p: a for p, a in peers}
        self.out_ring = out_ring
        self.out_fseqs = out_fseqs
        self.serve_slots = serve_slots
        self.max_requests = max_requests
        # served-side cache: slot -> {data shred idx -> wire}
        self._cache: dict[int, dict[int, bytes]] = {}
        self.metrics = {"shreds_seen": 0, "reqs_sent": 0, "sign_fail": 0,
                        "reqs_served": 0, "reqs_refused": 0,
                        "resps_in": 0, "cache_slots": 0,
                        "incomplete": 0}

    # -- gap tracking (shred stream consumer) -------------------------------

    def on_shred(self, wire: bytes):
        """Track a shred from turbine/repair AND cache it for serving
        (every validator serves repair from what it holds)."""
        try:
            s = fmt.parse_shred(wire)
        except Exception:
            return
        variant = wire[fmt.VARIANT_OFF]
        if not fmt.is_data(variant):
            return
        self.metrics["shreds_seen"] += 1
        if self._auto_anchor:
            self.forest = Forest(max(0, s.slot - max(1, s.parent_off)))
            self._auto_anchor = False
        self.forest.shred(
            s.slot, s.idx, parent_off=s.parent_off,
            slot_complete=bool(s.flags & fmt.FLAG_SLOT_COMPLETE))
        self._cache.setdefault(s.slot, {})[s.idx] = bytes(wire)
        while len(self._cache) > self.serve_slots:
            self._cache.pop(min(self._cache))
        self.metrics["cache_slots"] = len(self._cache)

    # -- client half --------------------------------------------------------

    def plan_and_send(self, now_ns: int | None = None) -> int:
        """Sign + transmit repair requests for the current gap set."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        self.metrics["incomplete"] = len(self.forest.frontier())
        sent = 0
        for peer, payload in self.policy.plan(
                self.forest, now_ns, max_requests=self.max_requests):
            sig = self.sign_fn(payload)
            if sig is None:
                self.metrics["sign_fail"] += 1
                continue
            addr = self.addr_of.get(peer)
            if addr is None:
                continue
            self.sock.sendto(payload + sig, addr)
            self.metrics["reqs_sent"] += 1
            sent += 1
        return sent

    # -- server half + response ingest (UDP datagrams) ----------------------

    def on_datagram(self, data: bytes, addr) -> int:
        """One datagram off the repair socket: either a peer's signed
        request (serve it) or a repair response (forward the shred).
        The shed gate polices FIRST — the cheapest reject runs before
        the ed25519 verify / shred parse an attacker would love us to
        pay per flood packet."""
        if self.shed is not None and not self.shed.admit(addr):
            return 0
        if len(data) == REQ_LEN + 64:
            return self._serve(data, addr)
        if fmt.SHRED_MIN_SZ <= len(data) <= fmt.SHRED_MAX_SZ:
            self.metrics["resps_in"] += 1
            self.on_shred(data)              # fills our own gap tracking
            if self.out_ring is not None:
                if self.shed is not None and self.out_fseqs and \
                        self.out_ring.credits(self.out_fseqs) <= 0:
                    # downstream pressure: latch overload so unstaked
                    # repair traffic degrades first at the door
                    self.shed.trip_overload()
                while self.out_fseqs and \
                        self.out_ring.credits(self.out_fseqs) <= 0:
                    time.sleep(20e-6)
                self.out_ring.publish(data, sig=len(data))
            return 1
        return 0

    def _serve(self, data: bytes, addr) -> int:
        disc, sender, recipient, ts_ms, nonce, slot, idx = \
            parse_request(data[:REQ_LEN])
        if disc < DISC_WINDOW_INDEX or disc > DISC_ANCESTOR_HASHES \
                or not verify(data[REQ_LEN:], sender, data[:REQ_LEN]):
            self.metrics["reqs_refused"] += 1
            return 0
        blk = self._cache.get(slot)
        wire = None
        if blk:
            if disc == DISC_WINDOW_INDEX:
                wire = blk.get(idx)
            elif disc in (DISC_HIGHEST_WINDOW, DISC_ORPHAN,
                          DISC_ANCESTOR_HASHES):
                wire = blk[max(blk)]
        if wire is not None:
            self.sock.sendto(wire, addr)
            self.metrics["reqs_served"] += 1
            return 1
        self.metrics["reqs_refused"] += 1
        return 0

    def poll_socket(self, max_pkts: int = 64) -> int:
        n = 0
        for _ in range(max_pkts):
            try:
                data, addr = self.sock.recvfrom(2048)
            except BlockingIOError:
                break
            except OSError:
                break
            n += self.on_datagram(data, addr)
        return n

    def publish_root(self, root_slot: int):
        self.forest.publish(root_slot)
