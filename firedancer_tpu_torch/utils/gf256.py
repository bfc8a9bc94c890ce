"""GF(2^8) arithmetic + Reed-Solomon matrices — host oracle (copy of the
JAX package's utils/gf256.py).

Field: GF(2^8) with primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D) —
the field Solana's erasure coding uses (ref: the reference's table
generator builds its constants from galois.GF(2**8) with this default
polynomial, src/ballet/reedsol/gen_tbls.py:7-11).

Code construction (same source, :9-11): extended Vandermonde
V[i,j] = i^j for i in [0, d+p), j in [0, d); the systematic parity
matrix is M = V[d:, :] @ inv(V[:d, :]), so parity[r] = sum_j M[r,j]*data[j]
and the first d codeword rows equal the data rows — byte-compatible with
the reference encoder and the Rust reed-solomon-erasure construction.

This module is the correctness oracle; the device path lives in
ops/reedsol.py (bit-matrix formulation) and must match it byte-for-byte.
The matrix products, the inverse's row operations, encode and recover
look each product up in one 256 x 256 multiplication table (`_MUL`),
whole rows at a time: the shred tiles encode and recover on the host,
a million products for a 32:32 set of 1 KB shreds.
"""
from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D

# exp/log tables over the multiplicative group (generator 2 is primitive
# for 0x11D)
_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= POLY
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]
# _MUL[a, b] = a * b in the field
_MUL = _EXP[_LOG[:, None] + _LOG[None, :]].astype(np.uint8)
_MUL[0, :] = 0
_MUL[:, 0] = 0


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] - _LOG[b]) % 255])


def gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * e) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (uint8 arrays): (n, k) @ (k, m)."""
    assert a.shape[1] == b.shape[0]
    return np.bitwise_xor.reduce(
        _MUL[np.asarray(a, np.uint8)[:, :, None],
             np.asarray(b, np.uint8)[None, :, :]], axis=1)


def mat_inv(a: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix inverse by Gauss-Jordan. Raises on singular."""
    n = a.shape[0]
    assert a.shape == (n, n)
    aug = np.zeros((n, 2 * n), np.uint8)
    aug[:, :n] = a
    for i in range(n):
        aug[i, n + i] = 1
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = _MUL[gf_inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= _MUL[aug[r, col]][aug[col]]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def parity_matrix(d: int, p: int) -> np.ndarray:
    """(p, d) systematic parity matrix M = V[d:, :] @ inv(V[:d, :])."""
    v = np.zeros((d + p, d), np.uint8)
    for i in range(d + p):
        for j in range(d):
            v[i, j] = gf_pow(i, j)
    top_inv = mat_inv(v[:d, :])
    return mat_mul(v[d:, :], top_inv)


def encode(data: np.ndarray, p: int) -> np.ndarray:
    """data (d, sz) uint8 -> parity (p, sz) uint8."""
    return mat_mul(parity_matrix(data.shape[0], p), data)


def recovery_matrix(d: int, p: int, present: list[int]) -> np.ndarray:
    """Rows that rebuild the d data shreds from d surviving shreds.

    present: sorted indices (in [0, d+p)) of d surviving shreds.
    Returns (d, d) matrix R with data = R @ surviving."""
    assert len(present) == d
    gen = np.zeros((d + p, d), np.uint8)          # full generator [I; M]
    for i in range(d):
        gen[i, i] = 1
    gen[d:, :] = parity_matrix(d, p)
    sub = gen[present, :]                          # (d, d)
    return mat_inv(sub)


def recover(shreds: dict[int, np.ndarray], d: int, p: int) -> np.ndarray:
    """shreds: {index: (sz,) uint8} with >= d entries -> data (d, sz)."""
    present = sorted(shreds)[:d]
    if len(present) < d:
        raise ValueError("not enough shreds")
    return mat_mul(recovery_matrix(d, p, present),
                   np.stack([np.asarray(shreds[s], np.uint8)
                             for s in present]))
