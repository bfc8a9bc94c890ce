"""Keccak-256, the port's copy of the JAX package's utils/keccak.py
(the Ethereum/Solana flavor: original Keccak padding
0x01, NOT SHA-3's 0x06).

Host-side oracle (ref: src/ballet/keccak256/fd_keccak256.c) serving
the sol_keccak256 syscall and the secp256k1 precompile's
address-from-pubkey derivation. Batch shaping onto the VPU is not
worth it at the precompile's call rate; the hot hashes (sha256/512,
blake3) already have device kernels.
"""
from __future__ import annotations

_ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56], [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(a: list[int]):
    for rnd in range(_ROUNDS):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1)
             for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & _M64
                    & b[(x + 2) % 5 + 5 * y])
        # iota
        a[0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    rate = 136                           # 1088-bit rate for 256-bit out
    a = [0] * 25
    # pad10*1 with the 0x01 domain byte (original Keccak); a single
    # pad byte collapses to 0x81
    pad_len = rate - (len(data) % rate)
    padded = bytearray(data) + bytearray(pad_len)
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(a)
    out = b"".join(a[i].to_bytes(8, "little") for i in range(4))
    return out
