"""Gossip tile: the CRDS protocol over UDP sockets (copy of the JAX
package's tiles/gossip.py, with gossvf on the port's kernels).

Binds gossip/protocol.py (push / pull / prune logic) to the wire the
way the reference's gossip tile drives fd_gossip over the net tile
(ref: src/discof/gossip/ + src/flamenco/gossip/fd_gossip.h protocol
pieces: entrypoint bootstrap via ContactInfo, push to the active set,
bloom pulls for anti-entropy, prunes on duplicate routes).

Wire format: the REAL Solana gossip protocol
(flamenco/gossip_wire.py; ref src/flamenco/gossip/fd_gossip_msg_parse.c)
— u32 LE message enum, bincode CrdsValues (signature + u32 tag +
payload), CrdsFilter pull requests, PruneData with the
\xffSOLANA_PRUNE_DATA signable, ping/pong liveness. CRDS values are
ed25519-signed over serialize(CrdsData) and verified on receipt (the
gossvf stage of the reference; host-rate signing via the oracle signer
— gossip is not the hot path).

With `device_verify`, each packet's CRDS values are checked as one
batch on `device` (gossip/gossvf.py: the strict kernels, or with
`gossvf_bulk` the RLC batch equation first). Without it the tile
verifies every value on the host oracle (utils/ed25519_ref): the
reference's own setting for a tile off the hot path, its default. The
prune signatures and the pull request's contact info are verified on the
host in either mode, as in the reference.

Where the copy differs from the reference:
  * a failing bulk warmup raises out of the constructor (the reference
    logs it and drops to individual-only);
  * `inject` counts as `bad_msg` only what the wire codec raises on bad
    bytes (`WireError`, `ValueError`, `struct.error`, `IndexError`,
    caught around the parse and the building of the CRDS values); an
    error of gossvf or of torch goes out of `poll_once`, so the stem
    marks the tile FAIL (the reference's catch-all, tiles/gossip.py:133,
    would count a device error as a hostile datagram and carry on)."""
from __future__ import annotations

import socket
import struct

from ..flamenco import gossip_wire as gw
from ..gossip import CrdsValue, GossipNode, gossvf
from ..gossip.bloom import Bloom
from ..gossip.crds import KIND_CONTACT_INFO
from ..utils.ed25519_ref import keypair, sign, verify

MTU = gw.MTU
# what the wire codec and CrdsValue raise on bad bytes
_BAD_BYTES = (gw.WireError, ValueError, struct.error, IndexError)


def _pack_containers(msg_type: int, sender: bytes, values) -> list[bytes]:
    """CRDS values -> one or more real push/pull-response datagrams,
    chunked to the gossip MTU and the 18-value cap."""
    out, cur, cur_sz = [], [], 44
    for v in values:
        w = v.to_wire()
        if cur and (cur_sz + len(w) > MTU
                    or len(cur) >= gw.MAX_CRDS_PER_MSG):
            out.append(gw.encode_container(msg_type, sender, cur))
            cur, cur_sz = [], 44
        cur.append(w)
        cur_sz += len(w)
    if cur:
        out.append(gw.encode_container(msg_type, sender, cur))
    return out


def _value_of(v: dict, index: int | None = None) -> CrdsValue:
    """A parsed CRDS value (gossip_wire.decode_value's dict) ->
    CrdsValue; a vote's index is its payload's first byte."""
    if index is None:
        index = v["payload"][0] if v["tag"] == gw.V_VOTE else 0
    return CrdsValue(v["origin"], v["tag"], index, v["wallclock_ms"],
                     v["payload"], v["signature"])


class GossipTile:
    def __init__(self, seed: bytes, port: int = 0,
                 bind_addr: str = "127.0.0.1", entrypoints=(),
                 stake_of=None, now_ms: int = 0,
                 device_verify: bool = False,
                 gossvf_bulk: bool = False, shed: dict | None = None,
                 device="cuda"):
        self.seed = seed
        self.device_verify = device_verify
        self.device = device
        # gossvf bulk pre-filter: verify each packet's CRDS values
        # through the RLC batch kernels first, individual strict verify
        # only when the batch equation fails (gossip/gossvf.py
        # mode="bulk" — cofactored semantics, sound for CRDS where the
        # only divergence class is the origin malleating its OWN sigs).
        # Run once NOW, in the BOOT window: a kernel that does not
        # build or launch fails the boot
        self.gossvf_bulk = bool(gossvf_bulk)
        if self.gossvf_bulk:
            gossvf.warmup_bulk(device)
        self.shed = None
        if shed is not None:
            from ..disco.shed import PeerGate
            self.shed = PeerGate(shed)
        _, _, self.pubkey = keypair(seed)
        self.node = GossipNode(
            self.pubkey, stake_of=stake_of,
            sign_fn=lambda msg: sign(self.seed, msg),
            verify_fn=lambda sig, origin, msg: verify(sig, origin, msg),
            now_ms=now_ms)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind_addr, port))
        self.sock.setblocking(False)
        self.addr = self.sock.getsockname()
        self.entrypoints = [tuple(e) if not isinstance(e, str)
                            else (e.rsplit(":", 1)[0],
                                  int(e.rsplit(":", 1)[1]))
                            for e in entrypoints]
        self._push_queue: list[CrdsValue] = []
        self._tick = 0
        self.metrics = {"gossvf_bad": 0,
                        "rx": 0, "tx": 0, "values": 0, "contacts": 0,
                        "bad_msg": 0, "shed": 0, "shed_unstaked": 0,
                        "peers": 0, "overload": 0,
                        "port": self.addr[1]}
        self.node.publish_contact_info(self.addr)

    # -- addressing ---------------------------------------------------------

    def _addr_of(self, pubkey: bytes):
        ci = self.node.crds.get(pubkey, KIND_CONTACT_INFO)
        if ci is None:
            return None
        try:
            info, _ = gw.ContactInfo.decode(ci.data, 0)
            return info.gossip_addr()
        except (gw.WireError, ValueError, struct.error):
            return None

    def _send(self, addr, payload: bytes):
        try:
            self.sock.sendto(payload[:65000], addr)
            self.metrics["tx"] += 1
        except OSError:
            pass

    # -- rx ----------------------------------------------------------------

    def inject(self, data: bytes, addr):
        """One datagram through the policed rx path (shared by the
        socket drain and the chaos traffic injector): the source
        address is policed BEFORE any parse/crypto work, hostile bytes
        die as bad_msg — never a crash; a device error raises."""
        self.metrics["rx"] += 1
        if self.shed is not None and not self.shed.admit(addr):
            return
        try:
            view = gw.parse_message(data)
            if view["kind"] in ("push", "pull_response"):
                values = [_value_of(v) for v in view["values"]]
            elif view["kind"] == "pull_request":
                # the requester's contact info rides in the message
                values = [_value_of(view["ci"], index=0)]
            else:
                values = []
        except _BAD_BYTES:
            self.metrics["bad_msg"] += 1
            return
        self._handle(view, values, addr)

    def poll_once(self) -> int:
        n = 0
        while n < 64:
            try:
                data, addr = self.sock.recvfrom(65536)
            except BlockingIOError:
                break
            n += 1
            self.inject(data, addr)
        if n >= 64 and self.shed is not None:
            # a full drain means ingest outpaces us: trip overload so
            # unstaked sources shed at the door for the hold window
            # (no out ring here — saturation IS the pressure signal)
            self.shed.trip_overload()
        self.metrics["values"] = len(self.node.crds.values)
        self.metrics["contacts"] = len(self.node.crds.contact_infos())
        if self.shed is not None:
            self.metrics.update(self.shed.counters())
        return n

    def _handle(self, view: dict, values: list, addr):
        kind = view["kind"]
        if kind in ("push", "pull_response"):
            if self.shed is not None and \
                    not self.shed.admit(view["from"]):
                # second policing axis: the CRDS SENDER identity (a
                # Sybil spams validly-signed values from throwaway
                # origins through one socket — the bounded peer table
                # + stake gate absorb it; keys are origin pubkey hex,
                # disjoint from the "ip:port" namespace by format)
                return
            pre = False
            if self.device_verify and values:
                # gossvf: ONE device batch checks the whole packet's
                # signatures (gossip/gossvf.py); invalid values drop.
                # mode="bulk" fronts the check with the RLC MSM kernel
                # (one batch equation per packet; strict individual
                # verify only for batches that fail it)
                verdicts = gossvf.batch_verify(
                    values, mode="bulk" if self.gossvf_bulk
                    else "individual", device=self.device)
                self.metrics["gossvf_bad"] += \
                    sum(1 for ok in verdicts if not ok)
                values = [v for v, ok in zip(values, verdicts) if ok]
                pre = True
            if kind == "push":
                fresh = self.node.handle_push(values,
                                              relayer=view["from"],
                                              pre_verified=pre)
                self._push_queue.extend(fresh)     # relay onward
            else:
                self.node.handle_pull_response(values,
                                               pre_verified=pre)
        elif kind == "pull_request":
            bloom = Bloom.from_filter(view["bloom_keys"],
                                      view["bloom_bits"],
                                      view["bloom_bits_cnt"])
            self.node.handle_push(values, relayer=values[0].origin)
            resp = self.node.handle_pull_request(bloom, limit=16)
            for payload in _pack_containers(gw.MSG_PULL_RESPONSE,
                                            self.pubkey, resp):
                self._send(addr, payload)
        elif kind == "prune":
            # either signable form is acceptable (verify_prune)
            ok = verify(view["signature"], view["from"],
                        gw.prune_signable(view["from"], view["origins"],
                                          view["destination"],
                                          view["wallclock_ms"],
                                          prefixed=True)) or \
                verify(view["signature"], view["from"],
                       gw.prune_signable(view["from"], view["origins"],
                                         view["destination"],
                                         view["wallclock_ms"],
                                         prefixed=False))
            if ok and view["destination"] == self.pubkey:
                self.node.handle_prune(view["from"], view["origins"])
            else:
                self.metrics["bad_msg"] += 1
        elif kind == "ping":
            import hashlib as _h
            pre = gw.pong_preimage(view["token"])
            sig = sign(self.seed, _h.sha256(pre).digest())
            self._send(addr, gw.encode_pong(self.pubkey, view["token"],
                                            sig))
        elif kind == "pong":
            pass                       # liveness bookkeeping only
        else:
            self.metrics["bad_msg"] += 1

    # -- periodic (stem housekeeping) ---------------------------------------

    def publish(self, kind: int, index: int, data: bytes):
        self._push_queue.append(self.node.make_value(kind, index, data))

    def housekeeping(self, now_ms: int | None = None):
        self._tick += 1
        self.node.tick(now_ms if now_ms is not None
                       else self.node.now_ms + 100)
        # refresh own contact info periodically (wallclock advances)
        if self._tick % 50 == 1:
            self._push_queue.append(
                self.node.publish_contact_info(self.addr))
        # push queued fresh values to the active set (or entrypoints
        # while we know no peers — the bootstrap hop)
        if self._push_queue:
            batch, self._push_queue = self._push_queue[:8], \
                self._push_queue[8:]
            targets: set = set()
            for v in batch:
                for pk in self.node.push_targets_for(v):
                    targets.add(self._addr_of(pk))
            if not targets:
                targets = set(self.entrypoints)
            payloads = _pack_containers(gw.MSG_PUSH, self.pubkey,
                                        batch)
            for addr in targets:
                if addr and addr != self.addr:
                    for payload in payloads:
                        self._send(addr, payload)
        # anti-entropy pull every few ticks
        if self._tick % 5 == 0:
            peers = [self._addr_of(c.origin)
                     for c in self.node.crds.contact_infos()
                     if c.origin != self.pubkey]
            peers = [p for p in peers if p] or list(self.entrypoints)
            if peers:
                addr = peers[self._tick // 5 % len(peers)]
                bloom = self.node.make_pull_request(seed=self._tick)
                keys, bits, nset = bloom.filter_fields()
                ci = self.node.crds.get(self.pubkey, KIND_CONTACT_INFO)
                self._send(addr, gw.encode_pull_request(
                    keys, bits, nset, (1 << 64) - 1, 0,
                    ci.to_wire(), bits_cnt=bloom.num_bits))
        # prunes for noisy relayers (PruneData signed with the
        # \xffSOLANA_PRUNE_DATA prefix form)
        for relayer, origins in self.node.prunes_due().items():
            addr = self._addr_of(relayer)
            if addr:
                wc = self.node.now_ms
                sig = sign(self.seed, gw.prune_signable(
                    self.pubkey, origins, relayer, wc, prefixed=True))
                self._send(addr, gw.encode_prune(
                    self.pubkey, origins, sig, relayer, wc))

    def close(self):
        self.sock.close()
