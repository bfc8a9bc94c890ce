"""Gossip node protocol logic: push / pull / prune over CRDS (copy of
the JAX package's gossip/protocol.py)
(ref: src/flamenco/gossip/fd_gossip.h:17-55 — the five protocol pieces:
entrypoint registration via ContactInfo, push to an active set, pull
with bloom filters for anti-entropy, prunes against duplicate routes,
ping/pong liveness for unstaked peers).

Transport-agnostic: methods consume/produce message tuples; the gossip
tile binds them to UDP via the sock tile. Signatures use the keyguard
seam (sign_fn); verification of received values uses verify_fn — both
optional for protocol-logic tests, mandatory on the wire.
"""
from __future__ import annotations

from ..flamenco import gossip_wire as gw
from .active_set import ActiveSet, PruneFinder
from .bloom import Bloom
from .crds import KIND_CONTACT_INFO, CrdsStore, CrdsValue


class GossipNode:
    def __init__(self, pubkey: bytes, stake_of=None, sign_fn=None,
                 verify_fn=None, active_set_size: int = 9,
                 now_ms: int = 0):
        self.pubkey = pubkey
        self.stake_of = stake_of or (lambda pk: 1)
        self.sign_fn = sign_fn
        self.verify_fn = verify_fn
        self.crds = CrdsStore()
        self.active = ActiveSet(pubkey, size=active_set_size)
        self.prune_finder = PruneFinder()
        self.now_ms = now_ms
        self.metrics = {"push_rx": 0, "push_dup": 0, "push_bad_sig": 0,
                        "pull_rq": 0, "pull_rs": 0, "pruned_by": 0}

    # -- local origination --------------------------------------------------

    def make_value(self, kind: int, index: int, data: bytes) -> CrdsValue:
        v = CrdsValue(self.pubkey, kind, index, self.now_ms, data)
        if self.sign_fn:
            v = CrdsValue(v.origin, v.kind, v.index, v.wallclock, v.data,
                          self.sign_fn(v.signable()))
        self.crds.upsert(v)
        return v

    def publish_contact_info(self, addr: tuple,
                             shred_version: int = 0) -> CrdsValue:
        """Real ContactInfo(11) payload with our gossip socket
        (flamenco/gossip_wire.ContactInfo)."""
        host, port = addr
        ci = gw.ContactInfo(
            pubkey=self.pubkey, wallclock_ms=self.now_ms,
            shred_version=shred_version,
            sockets={gw.SOCKET_GOSSIP: (host, int(port))})
        return self.make_value(KIND_CONTACT_INFO, 0, ci.encode())

    # -- push ---------------------------------------------------------------

    def push_targets_for(self, v: CrdsValue) -> list[bytes]:
        self.active.maybe_rotate(
            self.now_ms,
            {c.origin: self.stake_of(c.origin)
             for c in self.crds.contact_infos()})
        return self.active.push_targets(v.origin)

    def handle_push(self, values: list[CrdsValue],
                    relayer: bytes,
                    pre_verified: bool = False) -> list[CrdsValue]:
        """Ingest pushed values; returns the NEW ones (to relay onward).
        Duplicates feed the prune finder. pre_verified=True when a
        gossvf stage already batch-checked the signatures on device."""
        fresh = []
        for v in values:
            self.metrics["push_rx"] += 1
            if not pre_verified and self.verify_fn \
                    and not self.verify_fn(
                    v.signature, v.origin, v.signable()):
                self.metrics["push_bad_sig"] += 1
                continue
            if self.crds.upsert(v):
                self.prune_finder.record(v.hash(), v.origin, relayer)
                fresh.append(v)
            else:
                self.metrics["push_dup"] += 1
                self.prune_finder.record(v.hash(), v.origin, relayer)
        return fresh

    def prunes_due(self) -> dict[bytes, list]:
        """relayer pubkey -> origins to prune (send as prune messages;
        prune msgs lead with OUR pubkey — the keyguard's check)."""
        return self.prune_finder.prunes_due()

    def handle_prune(self, from_peer: bytes, origins: list[bytes]):
        self.metrics["pruned_by"] += 1
        self.active.handle_prune(from_peer, origins)

    # -- pull (anti-entropy) ------------------------------------------------

    def make_pull_request(self, seed: int = 0) -> Bloom:
        """Bloom of everything we hold; the tile wraps it in the real
        CrdsFilter wire (gossip_wire.encode_pull_request)."""
        self.metrics["pull_rq"] += 1
        return self.crds.bloom_of_contents(seed=seed)

    def handle_pull_request(self, bloom: Bloom,
                            limit: int = 64) -> list[CrdsValue]:
        self.metrics["pull_rs"] += 1
        return self.crds.missing_for(bloom, limit)

    def handle_pull_response(self, values: list[CrdsValue],
                             pre_verified: bool = False) -> int:
        n = 0
        for v in values:
            if not pre_verified and self.verify_fn \
                    and not self.verify_fn(
                    v.signature, v.origin, v.signable()):
                continue
            n += self.crds.upsert(v)
        return n

    # -- time ---------------------------------------------------------------

    def tick(self, now_ms: int):
        self.now_ms = now_ms
        self.crds.purge(now_ms)
