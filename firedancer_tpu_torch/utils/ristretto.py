"""ristretto255 (RFC 9496) — prime-order group over edwards25519 (copy of
the JAX package's utils/ristretto.py).

The reference ships ristretto alongside its ed25519
(ref: src/ballet/ed25519/fd_ristretto255.h — backing the
sol_curve_group_op / sol_curve_validate_point syscalls with
curve_id=CURVE25519_RISTRETTO, src/flamenco/vm/syscall/
fd_vm_syscall_curve.c). Host-side bigint implementation on the same
field as utils/ed25519_ref (documented non-constant-time host-oracle
discipline).

Encode/decode follow RFC 9496 §4.3.1/4.3.2 exactly (including the
canonicality and non-negativity rejections); group ops are the
underlying edwards ops — ristretto's quotient construction makes any
coset representative valid, equality is decided on encodings.
"""
from __future__ import annotations

from .ed25519_ref import BASEPOINT, D, P, pt_add, pt_mul

SQRT_M1 = pow(2, (P - 1) // 4, P)


def _is_neg(x: int) -> bool:
    return bool(x & 1)


def _abs(x: int) -> int:
    return P - x if _is_neg(x) else x


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v) or sqrt(i*u/v)) per RFC 9496 §4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u % P
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    was_square = correct or flipped
    return was_square, _abs(r)


def decode(b: bytes):
    """32 bytes -> edwards point (x,y,z,t) or None (RFC 9496 §4.3.1)."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or _is_neg(s):                 # canonical + non-negative
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P) * u1 % P - u2_sqr) % P
    ok, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    if not ok:
        return None
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if _is_neg(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p) -> bytes:
    """edwards point -> 32 bytes (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted = den1 * _invsqrt_a_minus_d() % P
    rotate = _is_neg(t0 * z_inv % P)
    if rotate:
        x, y = iy0, ix0
        den_inv = enchanted
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_neg(x * z_inv % P):
        y = P - y
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


_INVSQRT_A_MINUS_D = None


def _invsqrt_a_minus_d() -> int:
    """INVSQRT_A_MINUS_D = 1/sqrt(a − d), a = −1 (RFC 9496 §4.3.2)."""
    global _INVSQRT_A_MINUS_D
    if _INVSQRT_A_MINUS_D is None:
        _, r = sqrt_ratio_m1(1, (-1 - D) % P)
        _INVSQRT_A_MINUS_D = r
    return _INVSQRT_A_MINUS_D


def eq(p, q) -> bool:
    """Ristretto equality: x1*y2 == y1*x2 or y1*y2 == -x1*x2... the
    RFC decides on encodings; that is what we do (cheap at host
    rates and unambiguous)."""
    return encode(p) == encode(q)


def add(p, q):
    return pt_add(p, q)


def mul(k: int, p):
    return pt_mul(k, p)


def base():
    return BASEPOINT


def validate(b: bytes) -> bool:
    return decode(b) is not None
