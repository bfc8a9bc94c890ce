"""Bloom filter for gossip pull requests (copy of the JAX package's
gossip/bloom.py), wire-compatible with the cluster protocol
(ref: src/flamenco/gossip/fd_bloom.c — FNV-1a style position hashing
seeded by random u64 keys; the (keys, bits, num_bits_set) triple rides
inside the PullRequest CrdsFilter, fd_gossip_msg_parse.c
fd_gossip_pull_req_parse).

Position of a 32-byte CRDS hash under key k:
  h = k; for each byte: h ^= byte; h *= 0x100000001b3 (mod 2^64)
  bit = h % num_bits
"""
from __future__ import annotations

import math
import struct

_FNV_PRIME = 1099511628211
_M64 = (1 << 64) - 1


def _fnv(data: bytes, key: int) -> int:
    h = key
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _M64
    return h


class Bloom:
    def __init__(self, num_bits: int, keys: list[int]):
        if num_bits < 1:
            num_bits = 1
        self.num_bits = num_bits
        self.keys = list(keys) or [0]
        self.words = bytearray(8 * ((num_bits + 63) // 64))

    @classmethod
    def for_items(cls, n_items: int, fp_rate: float = 0.1,
                  seed: int = 0) -> "Bloom":
        """Size for a target false-positive rate (the reference's
        fd_bloom_initialize formulas); keys derive deterministically
        from `seed` so tests reproduce (the reference draws them from
        its rng — any values interoperate, they ride the wire)."""
        n = max(1, n_items)
        m = max(8, int(math.ceil(-n * math.log(max(fp_rate, 1e-9))
                                 / (math.log(2) ** 2))))
        k = max(1, round(m / n * math.log(2)))
        keys = [_fnv(struct.pack("<QI", seed, i), 0xcbf29ce484222325)
                for i in range(k)]
        return cls(m, keys)

    def insert(self, key: bytes):
        for k in self.keys:
            bit = _fnv(key, k) % self.num_bits
            self.words[bit >> 3] |= 1 << (bit & 7)

    def contains(self, key: bytes) -> bool:
        for k in self.keys:
            bit = _fnv(key, k) % self.num_bits
            if not self.words[bit >> 3] & (1 << (bit & 7)):
                return False
        return True

    @property
    def num_bits_set(self) -> int:
        return sum(bin(b).count("1") for b in self.words)

    # -- CrdsFilter wire fields ---------------------------------------------

    def filter_fields(self) -> tuple[list[int], bytes, int]:
        """(bloom_keys, bits words LE, num_bits_set) for
        encode_pull_request."""
        return self.keys, bytes(self.words), self.num_bits_set

    @classmethod
    def from_filter(cls, keys: list[int], bits: bytes,
                    num_bits: int) -> "Bloom":
        f = cls(num_bits or len(bits) * 8, keys)
        f.words[:len(bits)] = bits
        return f
