"""alt-bn128 (BN254) — G1/G2 group ops + the pairing check (copy of the
JAX package's utils/bn254.py).

The reference implements the full curve for the ZK precompile
syscalls (ref: src/ballet/bn254/fd_bn254_pairing.c, fd_bn254_g1.c —
backing sol_alt_bn128_group_op in src/flamenco/vm/syscall/). This is
the host-side oracle with the same precompile surface:

  * G1 point add / scalar mul over Fp (EIP-196 semantics: 32-byte
    big-endian coordinates, point-at-infinity = all zeros, inputs
    validated on-curve)
  * the PAIRING CHECK Π e(P_i, Q_i) == 1 (EIP-197 semantics: returns
    only the boolean)

Pairing construction: the REDUCED TATE pairing (Miller loop over the
group order r, final exponentiation (p¹²−1)/r) rather than the
optimal ate the reference/Agave use. The precompile exposes only the
product==1 verdict, and e_ate = e_tate^c for a fixed c coprime to r,
so Π e_ate = 1  ⇔  Π e_tate = 1 — the consensus-visible boolean is
IDENTICAL while the Miller loop stays free of the 6t+2 /
Frobenius-line machinery (the classic source of silent pairing bugs).
Individual pairing VALUES are not exposed, so nothing can observe the
construction difference.

Correctness gates (tests/test_bn254.py): curve/subgroup membership of
the standard generators, G1 group laws, pairing bilinearity
e(aP, bQ) = e(P, Q)^{ab} across several (a, b), non-degeneracy, and
the EIP-197 identity case. Host-rate bigint math (seconds per
pairing) — precompile oracle scope, not a hot path.
"""
from __future__ import annotations

# BN254 parameters (public constants)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B1 = 3                       # G1:  y^2 = x^3 + 3


def _inv(a: int, m: int = P) -> int:
    return pow(a, m - 2, m)


# -- Fp2 = Fp[u]/(u^2+1) ------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P,
            ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_inv(a):
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, (-a[1]) * d % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)

# twist curve G2: y^2 = x^3 + 3/(9+u)
XI = (9, 1)
B2 = f2_mul((B1, 0), f2_inv(XI))

# standard generators (verified on-curve + order-r by the tests)
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


# -- G1 (affine, None = infinity) ---------------------------------------------

def g1_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + B1)) % P == 0


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(k: int, p):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % P)


# -- G2 (affine over Fp2) -----------------------------------------------------

def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(f2_mul(x, x), x), B2)
    return lhs == rhs


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_mul(x1, x1), 3),
                     f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(k: int, p):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


def g2_in_subgroup(pt) -> bool:
    return g2_on_curve(pt) and g2_mul(R, pt) is None


# -- Fp12 as a pair of Fp6; Fp6 as a triple of Fp2 ---------------------------
# Fp6 = Fp2[v]/(v^3 - XI);  Fp12 = Fp6[w]/(w^2 - v)

def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2),
                                             f2_add(b1, b2)),
                                      f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul_v(a):
    """multiply by v: (a0, a1, a2) -> (XI*a2, a0, a1)."""
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))),
               f2_mul(a0, c0))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)),
                f6_add(t0, t1))
    return (c0, c1)


def f12_inv(a):
    a0, a1 = a
    t = f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def f12_pow(a, e: int):
    acc = F12_ONE
    while e:
        if e & 1:
            acc = f12_mul(acc, a)
        a = f12_mul(a, a)
        e >>= 1
    return acc


F12_ONE = (F6_ONE, F6_ZERO)


def _embed_g2(pt):
    """Untwist a G2 point into E(Fp12) coordinates.

    With the towering Fp12 = Fp6[w]/(w^2 - v), Fp6 = Fp2[v]/(v^3 - XI)
    the D-twist map sends (x', y') -> (x' * w^2, y' * w^3):
      w^2 = v (as an Fp6 element), so x = x'·v  lives in c1 of Fp6, w^0
      w^3 = v·w, so                  y = y'·v·w lives in c1 of Fp6, w^1
    The image satisfies y^2 = x^3 + 3 over Fp12 (checked in tests)."""
    x2, y2 = pt
    x12 = ((F2_ZERO, x2, F2_ZERO), F6_ZERO)
    y12 = (F6_ZERO, (F2_ZERO, y2, F2_ZERO))
    return (x12, y12)


def _f12_from_fp(c: int):
    return (((c % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _f12_scale_fp(a, c: int):
    return tuple(tuple(f2_scalar(x, c) for x in a6) for a6 in a)


def _line(p1, p2, q12):
    """Evaluate the line through p1, p2 (G1 affine points) at the
    embedded point q12 = (xq, yq) in Fp12. Returns an Fp12 value."""
    x1, y1 = p1
    xq, yq = q12
    if x1 == p2[0] and y1 == p2[1]:
        lam_n = 3 * x1 * x1 % P
        lam_d = 2 * y1 % P
    elif x1 == p2[0]:
        # vertical line: x - x1
        return _f12_add(xq, _f12_from_fp(-x1 % P))
    else:
        lam_n = (p2[1] - y1) % P
        lam_d = (p2[0] - x1) % P
    lam = lam_n * _inv(lam_d) % P
    # yq - y1 - lam*(xq - x1)
    t = _f12_add(yq, _f12_from_fp(-y1 % P))
    u = _f12_add(xq, _f12_from_fp(-x1 % P))
    return _f12_add(t, _f12_scale_fp(u, (-lam) % P))


def _f12_add(a, b):
    return tuple(f6_add(x, y) for x, y in zip(a, b))


def _miller(p, q12):
    """f_{R,p} evaluated at q12 (Tate: loop over the group order r)."""
    f = F12_ONE
    t = p
    for bit in bin(R)[3:]:
        f = f12_mul(f12_mul(f, f), _line(t, t, q12))
        t = g1_add(t, t)
        if bit == "1":
            if t is None:
                f = f12_mul(f, _line_vertical(p, q12))
                t = p
            else:
                f = f12_mul(f, _line(t, p, q12))
                t = g1_add(t, p)
    return f


def _line_vertical(p, q12):
    return _f12_add(q12[0], _f12_from_fp(-p[0] % P))


def pairing_check(pairs, validate: bool = True) -> bool:
    """Π e(P_i, Q_i) == 1 over (g1_point, g2_point) pairs — the
    EIP-197 verdict. None entries (points at infinity) contribute the
    identity. Raises ValueError on points off curve/subgroup;
    validate=False skips the (expensive) subgroup re-check for points
    that already came through dec_g1/dec_g2."""
    acc = F12_ONE
    n_real = 0
    for p, q in pairs:
        if validate:
            if not g1_on_curve(p):
                raise ValueError("g1 point not on curve")
            if q is not None and not g2_in_subgroup(q):
                raise ValueError("g2 point not in subgroup")
        if p is None or q is None:
            continue
        acc = f12_mul(acc, _miller(p, _embed_g2(q)))
        n_real += 1
    if n_real == 0:
        return True
    final = f12_pow(acc, (P ** 12 - 1) // R)
    return final == F12_ONE


# -- EIP-196/197 serialization ------------------------------------------------

def dec_g1(b: bytes):
    if len(b) != 64:
        raise ValueError("g1 encoding must be 64 bytes")
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:], "big")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not g1_on_curve(pt):
        raise ValueError("g1 point not on curve")
    return pt


def enc_g1(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def dec_g2(b: bytes):
    """EIP-197 G2: (x_imag, x_real, y_imag, y_real) 32B each.
    Non-canonical coordinates (>= P) are rejected like the reference
    does — implicit mod-P reduction would accept encodings Agave
    errors on."""
    if len(b) != 128:
        raise ValueError("g2 encoding must be 128 bytes")
    xi = int.from_bytes(b[0:32], "big")
    xr = int.from_bytes(b[32:64], "big")
    yi = int.from_bytes(b[64:96], "big")
    yr = int.from_bytes(b[96:128], "big")
    if any(c >= P for c in (xi, xr, yi, yr)):
        raise ValueError("g2 coordinate not canonical")
    if xi == xr == yi == yr == 0:
        return None
    pt = ((xr, xi), (yr, yi))
    if not g2_in_subgroup(pt):
        raise ValueError("g2 point not on curve/subgroup")
    return pt


def _sized(data: bytes, want: int) -> bytes:
    """Short input zero-pads (EIP semantics); LONGER input is an
    error, matching the reference's InvalidInputData."""
    if len(data) > want:
        raise ValueError(f"input {len(data)} exceeds {want}")
    return data.ljust(want, b"\x00")


def alt_bn128_add(data: bytes) -> bytes:
    data = _sized(data, 128)
    return enc_g1(g1_add(dec_g1(data[:64]), dec_g1(data[64:128])))


def alt_bn128_sub(data: bytes) -> bytes:
    data = _sized(data, 128)
    return enc_g1(g1_add(dec_g1(data[:64]),
                         g1_neg(dec_g1(data[64:128]))))


def alt_bn128_mul(data: bytes) -> bytes:
    data = _sized(data, 96)
    k = int.from_bytes(data[64:96], "big")
    return enc_g1(g1_mul(k, dec_g1(data[:64])))


def alt_bn128_pairing(data: bytes) -> bytes:
    """EIP-197: input = n x 192 bytes (G1 ‖ G2); output 32 bytes
    0/1."""
    if len(data) % 192:
        raise ValueError("pairing input must be a multiple of 192")
    pairs = []
    for off in range(0, len(data), 192):
        pairs.append((dec_g1(data[off:off + 64]),
                      dec_g2(data[off + 64:off + 192])))
    ok = pairing_check(pairs, validate=False)   # decoded above
    return (1 if ok else 0).to_bytes(32, "big")
