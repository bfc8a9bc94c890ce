"""Pure-python RFC 8032 ed25519 (bigint) — the host-side reference
implementation.

The port's own copy of the JAX package's utils/ed25519_ref.py. It signs
synthetic load (tiles/synth.py), re-verifies deferred duplicates in the
verify tile, and is the oracle for the port's kernels.

Deliberately independent of ops/: bigints + hashlib only.
"""
from __future__ import annotations

import functools
import hashlib

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P


def pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * (2 * D) % P * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (dd - c) % P, (dd + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_mul(k, p):
    q = (0, 1, 1, 0)
    while k:
        if k & 1:
            q = pt_add(q, p)
        p = pt_add(p, p)
        k >>= 1
    return q


def pt_compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def pt_decompress(b: bytes):
    v = int.from_bytes(b, "little")
    sign, y = v >> 255, v & ((1 << 255) - 1)
    if y >= P:
        return None
    u, vv = (y * y - 1) % P, (D * y * y + 1) % P
    x = u * pow(vv, 3, P) % P * pow(u * pow(vv, 7, P) % P, (P - 5) // 8, P) % P
    if vv * x * x % P == u:
        pass
    elif vv * x * x % P == P - u:
        x = x * pow(2, (P - 1) // 4, P) % P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _basepoint():
    by = 4 * pow(5, P - 2, P) % P
    pt = pt_decompress(by.to_bytes(32, "little"))
    assert pt is not None
    return pt


BASEPOINT = _basepoint()


def keypair(seed: bytes):
    """seed (32B) -> (secret scalar, prefix, public key bytes)."""
    return _keypair(bytes(seed))


# synthetic load signs thousands of messages with a pool of 16 keys:
# cached, a signature pays one scalar multiplication, not three
@functools.lru_cache(maxsize=256)
def _keypair(seed: bytes):
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    pub = pt_compress(pt_mul(a, BASEPOINT))
    return a, h[32:], pub


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix, pub = keypair(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    rb = pt_compress(pt_mul(r, BASEPOINT))
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(), "little") % L
    s = (r + k * a) % L
    return rb + s.to_bytes(32, "little")


def is_small_order(p) -> bool:
    """[8]P == identity (the 8-torsion subgroup)."""
    q = pt_mul(8, p)
    zi = pow(q[2], P - 2, P)
    return (q[0] * zi % P, q[1] * zi % P) == (0, 1)


def verify(sig: bytes, pub: bytes, msg: bytes) -> bool:
    """Cofactorless verify with S >= l (malleability) rejection AND
    small-order A/R rejection (verify_strict) — same semantics as the
    JAX kernel and the reference's fd_ed25519_verify
    (ref: src/ballet/ed25519/fd_ed25519_user.c:159-201)."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = pt_decompress(pub)
    if a is None or is_small_order(a):
        return False
    r_pt = pt_decompress(sig[:32])
    if r_pt is not None and is_small_order(r_pt):
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % L
    neg_a = (P - a[0], a[1], a[2], P - a[3])
    rp = pt_add(pt_mul(s, BASEPOINT), pt_mul(k, neg_a))
    return pt_compress(rp) == sig[:32]
