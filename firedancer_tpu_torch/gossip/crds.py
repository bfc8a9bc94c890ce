"""CRDS: the conflict-free replicated data store under gossip (copy of
the JAX package's gossip/crds.py)
(ref: src/flamenco/gossip/crds/ — the value table; data model per the
public gossip spec the reference cites in fd_gossip.h).

Values are keyed by (origin pubkey, kind, index): one ContactInfo per
node, one Vote per (node, vote index), etc. Upserts resolve by
wallclock — strictly newer wins, ties keep the incumbent — so the store
converges regardless of arrival order (last-writer-wins CRDT). Each
value's 32-byte hash (over the signed payload) is the identity used by
pull-request bloom filters.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..flamenco import gossip_wire as gw

# value kinds — the REAL CRDS discriminants (r5 interop:
# flamenco/gossip_wire.py; ref src/flamenco/gossip/fd_gossip_private.h:37-51)
KIND_LEGACY_CONTACT_INFO = gw.V_LEGACY_CONTACT_INFO   # 0
KIND_VOTE = gw.V_VOTE                                 # 1
KIND_LOWEST_SLOT = gw.V_LOWEST_SLOT                   # 2
KIND_SNAPSHOT_HASHES = gw.V_LEGACY_SNAPSHOT_HASHES    # 3
KIND_EPOCH_SLOTS = gw.V_EPOCH_SLOTS                   # 5
KIND_NODE_INSTANCE = gw.V_NODE_INSTANCE               # 8
KIND_DUPLICATE_SHRED = gw.V_DUPLICATE_SHRED           # 9
KIND_CONTACT_INFO = gw.V_CONTACT_INFO                 # 11


@dataclass(frozen=True)
class CrdsValue:
    """In-memory CRDS value over the REAL wire encoding: `data` is the
    bincode variant payload (the bytes after the u32 discriminant) and
    every derived form (signable region, identity hash, wire bytes)
    matches Agave's CrdsValue semantics byte-for-byte."""
    origin: bytes          # 32B pubkey of the producing node
    kind: int              # CRDS discriminant (u32 on the wire)
    index: int             # vote index (0 for single-instance kinds)
    wallclock: int         # producer's clock, ms — LWW resolution key
    data: bytes            # bincode variant payload
    signature: bytes = b""

    def __post_init__(self):
        # fixed-width wire fields: a wrong-length origin/signature
        # doesn't fail here, it SHIFTS every later byte of the encoded
        # frame, so the peer decodes garbage under a valid-looking tag
        if len(self.origin) != 32:
            raise ValueError(
                f"CRDS origin must be a 32-byte pubkey, got "
                f"{len(self.origin)}")
        if self.signature and len(self.signature) != 64:
            raise ValueError(
                f"CRDS signature must be 64 bytes (or empty for "
                f"unsigned), got {len(self.signature)}")

    def key(self) -> tuple:
        return (self.origin, self.kind, self.index)

    def signable(self) -> bytes:
        """The signed region: serialize(CrdsData) = u32 tag + payload
        (ref fd_gossvf_tile.c verify_crds_value)."""
        return gw.signable(self.kind, self.data)

    def to_wire(self) -> bytes:
        return gw.encode_value(self.kind, self.data,
                               self.signature or bytes(64))

    def hash(self) -> bytes:
        """Identity hash over the full serialized value — the key pull
        blooms filter on (Agave CrdsValue hash semantics)."""
        return gw.value_hash(self.to_wire())

    @classmethod
    def from_wire(cls, b: bytes, off: int = 0) -> tuple["CrdsValue", int]:
        v, end = gw.decode_value(b, off)
        index = v["payload"][0] if v["tag"] == gw.V_VOTE else 0
        return cls(v["origin"], v["tag"], index, v["wallclock_ms"],
                   v["payload"], v["signature"]), end


class CrdsStore:
    def __init__(self, max_age_ms: int = 60_000):
        self.values: dict[tuple, CrdsValue] = {}
        self.hashes: set[bytes] = set()
        self.max_age_ms = max_age_ms
        self.metrics = {"upserts": 0, "stale": 0, "purged": 0}

    def upsert(self, v: CrdsValue) -> bool:
        """True if inserted (new or strictly newer wallclock)."""
        cur = self.values.get(v.key())
        if cur is not None and cur.wallclock >= v.wallclock:
            self.metrics["stale"] += 1
            return False
        if cur is not None:
            self.hashes.discard(cur.hash())
        self.values[v.key()] = v
        self.hashes.add(v.hash())
        self.metrics["upserts"] += 1
        return True

    def get(self, origin: bytes, kind: int, index: int = 0):
        return self.values.get((origin, kind, index))

    def contact_infos(self):
        return [v for v in self.values.values()
                if v.kind == KIND_CONTACT_INFO]

    def missing_for(self, bloom, limit: int = 64) -> list[CrdsValue]:
        """Pull-response: values whose hash the requester's bloom lacks
        (ref: pull protocol in fd_gossip.h)."""
        out = []
        for v in self.values.values():
            if not bloom.contains(v.hash()):
                out.append(v)
                if len(out) >= limit:
                    break
        return out

    def bloom_of_contents(self, fp_rate: float = 0.05, seed: int = 0):
        from .bloom import Bloom
        f = Bloom.for_items(max(len(self.hashes), 8), fp_rate, seed)
        for h in self.hashes:
            f.insert(h)
        return f

    def purge(self, now_ms: int):
        """Drop values older than the age window (the reference purges
        by wallclock the same way; ContactInfos keep peers alive)."""
        dead = [k for k, v in self.values.items()
                if now_ms - v.wallclock > self.max_age_ms]
        for k in dead:
            self.hashes.discard(self.values[k].hash())
            del self.values[k]
        self.metrics["purged"] += len(dead)
