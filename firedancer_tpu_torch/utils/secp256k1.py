"""secp256k1 ECDSA: sign / verify / recover (host oracle; copy of the
JAX package's utils/secp256k1.py).

Backs the secp256k1 precompile (ref: src/ballet/secp256k1/ — the
reference wraps libsecp256k1; this is a clean-room bigint
implementation of the same math). Recovery follows SEC 1 §4.1.6: from
(r, s, recovery_id) and the message hash, reconstruct R and compute
Q = r^-1 (s·R - z·G). Ethereum-style addresses derive as
keccak256(uncompressed_pubkey[1:])[12:].
"""
from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def _lift_x(x: int, odd: bool):
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != odd:
        y = P - y
    return x, y


def pubkey_bytes(q) -> bytes:
    """Uncompressed SEC1: 0x04 | X | Y."""
    return b"\x04" + q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def eth_address(q) -> bytes:
    from .keccak import keccak256
    return keccak256(pubkey_bytes(q)[1:])[12:]


def sign(priv: int, msg_hash: bytes) -> tuple[int, int, int]:
    """-> (r, s, recovery_id); deterministic k (RFC 6979 flavor via
    HMAC-SHA256 — test/oracle use, not consensus)."""
    z = int.from_bytes(msg_hash, "big") % N
    k = int.from_bytes(hmac.new(
        priv.to_bytes(32, "big"), msg_hash, hashlib.sha256).digest(),
        "big") % N or 1
    while True:
        R = _mul(k, (GX, GY))
        r = R[0] % N
        if r:
            s = _inv(k, N) * (z + r * priv) % N
            if s:
                break
        k = (k + 1) % N or 1
    rec = (1 if R[1] & 1 else 0) | (2 if R[0] >= N else 0)
    if s > N // 2:                       # low-s normalization flips parity
        s = N - s
        rec ^= 1
    return r, s, rec


def verify(q, msg_hash: bytes, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(msg_hash, "big") % N
    w = _inv(s, N)
    pt = _add(_mul(z * w % N, (GX, GY)), _mul(r * w % N, q))
    return pt is not None and pt[0] % N == r


def recover(msg_hash: bytes, r: int, s: int, rec_id: int):
    """-> pubkey point or None (SEC 1 §4.1.6)."""
    if not (1 <= r < N and 1 <= s < N and 0 <= rec_id <= 3):
        return None
    x = r + N * (rec_id >> 1)
    R = _lift_x(x, bool(rec_id & 1))
    if R is None:
        return None
    z = int.from_bytes(msg_hash, "big") % N
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    q = _add(_mul(s * rinv % N, R),
             _mul((-z * rinv) % N, (GX, GY)))
    if q is None:
        return None
    return q
