"""ChaCha20 block function + counter-mode RNG (copy of the JAX package's
utils/chacha.py; ref: src/ballet/chacha/fd_chacha_rng.h — the RNG behind
leader-schedule sampling and the turbine shuffle, shred/shred_dest.py).

Clean-room RFC 8439 quarter-round construction. The RNG yields u64s
from successive 64-byte keystream blocks (little-endian), matching the
reference's consumption pattern of whole words from sequential blocks.
"""
from __future__ import annotations

import struct

_M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & _M32


def _qr(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & _M32
    st[d] = _rotl(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotl(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & _M32
    st[d] = _rotl(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotl(st[b] ^ st[c], 7)


def chacha20_block(key: bytes, counter: int, nonce: bytes = bytes(12),
                   rounds: int = 20) -> bytes:
    """One 64-byte keystream block (RFC 8439 state layout)."""
    assert len(key) == 32 and len(nonce) == 12
    init = list(_CONSTANTS) + list(struct.unpack("<8I", key)) + \
        [counter & _M32] + list(struct.unpack("<3I", nonce))
    st = list(init)
    for _ in range(rounds // 2):
        _qr(st, 0, 4, 8, 12)
        _qr(st, 1, 5, 9, 13)
        _qr(st, 2, 6, 10, 14)
        _qr(st, 3, 7, 11, 15)
        _qr(st, 0, 5, 10, 15)
        _qr(st, 1, 6, 11, 12)
        _qr(st, 2, 7, 8, 13)
        _qr(st, 3, 4, 9, 14)
    out = [(s + i) & _M32 for s, i in zip(st, init)]
    return struct.pack("<16I", *out)


class ChaChaRng:
    """Deterministic u64 stream from a 32-byte seed."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = seed
        self.counter = 0
        self._buf = b""

    def next_u64(self) -> int:
        if len(self._buf) < 8:
            self._buf += chacha20_block(self.key, self.counter)
            self.counter += 1
        v = struct.unpack_from("<Q", self._buf, 0)[0]
        self._buf = self._buf[8:]
        return v

    def roll_u64(self, bound: int) -> int:
        """Unbiased uniform in [0, bound) via rejection (multiply-shift
        would bias; the reference uses the same reject-loop shape)."""
        assert bound > 0
        zone = (1 << 64) - ((1 << 64) % bound)
        while True:
            v = self.next_u64()
            if v < zone:
                return v % bound

    def roll_mod(self, bound: int) -> int:
        """Uniform in [0, bound) matching Rust rand 0.7
        Uniform<u64>::sample — the widening-multiply rejection with the
        LARGEST k (MODE_MOD), as consumed by Agave's leader-schedule
        WeightedIndex draws (ref: src/ballet/chacha/fd_chacha_rng.h
        fd_chacha20_rng_ulong_roll, FD_CHACHA_RNG_MODE_MOD): accept
        v·n's low half when <= 2^64-1 - (2^64-n)%n, answer is the high
        half."""
        assert 0 < bound < 1 << 64
        m = (1 << 64) - 1
        zone = m - (m - bound + 1) % bound
        while True:
            res = self.next_u64() * bound
            if res & m <= zone:
                return res >> 64

    def roll_shift(self, bound: int) -> int:
        """Uniform in [0, bound) with the power-of-two zone (MODE_SHIFT)
        — the variant Agave's Turbine weighted shuffle consumes (ref:
        src/ballet/chacha/fd_chacha_rng.h: zone =
        (n << (63 - msb(n))) - 1)."""
        assert 0 < bound < 1 << 64
        m = (1 << 64) - 1
        zone = ((bound << (64 - bound.bit_length())) - 1) & m
        while True:
            res = self.next_u64() * bound
            if res & m <= zone:
                return res >> 64
