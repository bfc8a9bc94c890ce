"""secp256r1 (NIST P-256) ECDSA verification — host path (copy of the
JAX package's utils/secp256r1.py).

Backs the secp256r1 precompile (ref: src/ballet/secp256r1/ — P-256
VERIFY only, the SIMD-0075 precompile; the reference vendors a
constrained s2n-bignum build for it). Verification-only scope matches
the reference: the validator never signs with P-256.

Low-rate control-plane arithmetic in Python bigints (same discipline
as utils/secp256k1.py — documented there); the Jacobian ladder keeps
verify latency in the hundreds of microseconds.

Signature malleability: per RFC 6979 / Agave's precompile, `s` MUST be
in the low half (s <= n/2) — high-s signatures are rejected, matching
the reference's strict verifier.
"""
from __future__ import annotations

import hashlib

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


# Jacobian coordinates (X, Y, Z): x = X/Z^2, y = Y/Z^3


def _jdbl(p):
    x, y, z = p
    if not y:
        return (0, 1, 0)
    ysq = y * y % P
    s = 4 * x * ysq % P
    m = (3 * x * x + A * z * z % P * z % P * z) % P
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = 2 * y * z % P
    return (nx, ny, nz)


def _jadd(p, q):
    if not p[2]:
        return q
    if not q[2]:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1s = z1 * z1 % P
    z2s = z2 * z2 % P
    u1 = x1 * z2s % P
    u2 = x2 * z1s % P
    s1 = y1 * z2s % P * z2 % P
    s2 = y2 * z1s % P * z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jdbl(p)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = h * h % P
    h3 = h2 * h % P
    nx = (r * r - h3 - 2 * u1 * h2) % P
    ny = (r * (u1 * h2 - nx) - s1 * h3) % P
    nz = h * z1 % P * z2 % P
    return (nx, ny, nz)


def _jmul(k: int, pt):
    acc = (0, 1, 0)
    add = (pt[0], pt[1], 1)
    while k:
        if k & 1:
            acc = _jadd(acc, add)
        add = _jdbl(add)
        k >>= 1
    return acc


def _affine(p):
    x, y, z = p
    if not z:
        return None
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P)


def on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + A * x + B)) % P == 0


def decompress(pub33: bytes):
    """SEC1 compressed point (02/03 ‖ x) -> (x, y) or None."""
    if len(pub33) != 33 or pub33[0] not in (2, 3):
        return None
    x = int.from_bytes(pub33[1:], "big")
    if x >= P:
        return None
    y2 = (x * x * x + A * x + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (pub33[0] & 1):
        y = P - y
    return (x, y)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ECDSA-SHA256 verify. pub: 33-byte SEC1 compressed; sig: 64-byte
    r‖s big-endian with the low-s rule enforced."""
    if len(sig) != 64:
        return False
    q = decompress(pub)
    if q is None or not on_curve(*q):
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N) or not (1 <= s < N):
        return False
    if s > N // 2:
        return False                       # high-s malleability
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = _inv(s, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = _jadd(_jmul(u1, (GX, GY)), _jmul(u2, q))
    aff = _affine(pt)
    if aff is None:
        return False
    return aff[0] % N == r
