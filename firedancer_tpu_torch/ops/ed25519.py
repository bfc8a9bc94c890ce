"""Strict and RLC batch ed25519 verification as plain PyTorch (the port's
CPU path, the plain version of the fused verify kernel, and the glue
around the kernels).

Counterpart of the JAX package's ops/ed25519.py (scalars, decompression,
small-order encodings, fixed-base table, `rlc_verify_batch`,
`verify_batch_rlc`) and of the strict glue plus kernel body of
ops/pallas_ed.py (`verify_batch`, `_verify_core`). Field arithmetic is
ops/fe25519.py, in the kernel's own limb scheme; the plain versions of
the two MSM kernels are ops/msm.py.

Semantics (RFC 8032 with the reference's strict rules,
ref: src/ballet/ed25519/fd_ed25519_user.c:136-230): S < l, A.y < p, A
and R not of small order, cofactorless [S]B + [k](-A) == R compared as
canonical encodings.

Scalars are 32-byte little-endian tensors. `sc_reduce64` folds a 512-bit
value mod l in 21-bit digits with int64 sums (the ref10 fold constants),
which is what the kernels do per thread; the RLC products z k, z S and
the lane sum are formed in the same 21-bit digits and folded by it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as _device
from . import fe25519 as fe
from .fe25519 import P

L = (1 << 252) + 27742317777372353535851937790883648493
# -delta in signed 21-bit digits, delta = l - 2^252: 2^252 = sum SC_C[m]
# 2^(21 m) (mod l), so digit n >= 12 folds into digits n-12 .. n-7
SC_C = (666643, 470296, 654183, -997805, 136657, -683901)
ONE_LIMBS = fe.int_to_limbs(1)


# ---------------------------------------------------------------------------
# scalars mod l
# ---------------------------------------------------------------------------

def _fold(s: list, n: int):
    for m, c in enumerate(SC_C):
        s[n - 12 + m] = s[n - 12 + m] + s[n] * c
    s[n] = torch.zeros_like(s[n])


def _carry21(s: list, lo: int, hi: int):
    for i in range(lo, hi):
        c = s[i] >> 21
        s[i] = s[i] - (c << 21)
        s[i + 1] = s[i + 1] + c


def _digits21(b: torch.Tensor, n: int) -> list:
    """(..., m) uint8 LE -> n int64 digits of 21 bits, the last one
    holding every bit from 21 (n - 1) up."""
    x = b.to(torch.int64)
    x = torch.cat([x, torch.zeros_like(x[..., :5])], dim=-1)
    s = []
    for i in range(n):
        a, r = divmod(21 * i, 8)
        v = (x[..., a] | (x[..., a + 1] << 8) | (x[..., a + 2] << 16)
             | (x[..., a + 3] << 24) | (x[..., a + 4] << 32))
        s.append((v >> r) & ((1 << 21) - 1) if i < n - 1 else v >> r)
    return s


def _digits_to_bytes(s: list, nbytes: int) -> torch.Tensor:
    """Non-negative 21-bit digits -> (..., nbytes) uint8 LE, zero-filled
    past the digits' last bit."""
    out, acc, nb = [], torch.zeros_like(s[0]), 0
    for dgt in s:
        acc = acc | (dgt << nb)
        nb += 21
        while nb >= 8 and len(out) < nbytes:
            out.append(acc & 0xFF)
            acc = acc >> 8
            nb -= 8
    while len(out) < nbytes:
        out.append(acc & 0xFF)
        acc = acc >> 8
    return torch.stack(out, dim=-1).to(torch.uint8)


def sc_reduce64(b: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 LE -> (..., 32) uint8 LE canonical value mod l.

    24 digits of 21 bits (the top one 29), fold digits 23..18, carry
    6..16, fold 17..12, carry 0..11; the value is then D + s12 2^252 with
    |s12| < 2^12. Two more fold+carry rounds leave it in (-delta, l),
    and one conditional add of l (when s12 = -1) makes it canonical.
    Every sum stays below 2^53 in magnitude."""
    s = _digits21(b, 24)
    for n in range(23, 17, -1):
        _fold(s, n)
    _carry21(s, 6, 17)
    for n in range(17, 11, -1):
        _fold(s, n)
    _carry21(s, 0, 12)
    for _ in range(2):
        _fold(s, 12)
        _carry21(s, 0, 12)
    t = s[12] >> 1                       # -1 iff the value is negative
    for m, c in enumerate(SC_C):
        s[m] = s[m] + t * c              # + l: digits of delta, and
    s[12] = s[12] - t                    # + 2^252
    _carry21(s, 0, 12)
    return _digits_to_bytes(s[:13], 32)


def sc_mul_mod_l(a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 scalar (any value below 2^256) times (..., 16)
    uint8 z, mod l -> (..., 32) uint8 canonical (the JAX sc_mul_mod_l).

    13 x 7 digit products of 21 bits, each below 2^42; a column sums at
    most 7 of them, below 2^45 in int64. The product, below 2^384, is
    carried to 21-bit digits and folded by sc_reduce64."""
    ad, zd = _digits21(a, 13), _digits21(z, 7)
    p = [torch.zeros_like(ad[0]) for _ in range(20)]
    for i, x in enumerate(ad):
        for j, y in enumerate(zd):
            p[i + j] = p[i + j] + x * y
    _carry21(p, 0, 19)
    return sc_reduce64(_digits_to_bytes(p, 64))


def sc_digit_sums(s: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """(..., 32) uint8 scalars -> int64 column sums of their 21-bit
    digits over batch axis `dim`, digits last: (B, 32) -> (13,), and
    (G, L, 32) with dim=1 -> (G, 13). The last digit holds bits 252 and
    up. A column sums B values below 2^21, below 2^63 for B < 2^42."""
    return torch.stack([x.sum(dim) for x in _digits21(s, 13)], -1)


def sc_reduce_digits(d: torch.Tensor) -> torch.Tensor:
    """(13,) int64 digit sums (non-negative) -> (32,) uint8, their value
    mod l: carried to 25 digits of 21 bits and folded by sc_reduce64
    (value below 2^512). The MSM stage 2 kernel does the same."""
    d = list(d.unbind(-1)) + [torch.zeros_like(d[..., 0]) for _ in range(12)]
    _carry21(d, 0, 24)
    return sc_reduce64(_digits_to_bytes(d, 64))


def sc_sum_mod_l(s: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 scalars -> (32,) uint8, their sum mod l (the JAX
    sc_sum_mod_l over axis 0): the digit sums, then their reduction
    (B < 2^42)."""
    return sc_reduce_digits(sc_digit_sums(s))


def _bytes_lt(b: torch.Tensor, const_int: int,
              mask_top7: bool = False) -> torch.Tensor:
    """(..., 32) uint8 < const as LE integers: the sign of the most
    significant differing byte (one vectorized pass, no digit
    conversion)."""
    c = torch.tensor(list(const_int.to_bytes(32, "little")),
                     dtype=torch.int16, device=b.device)
    x = b.to(torch.int16)
    if mask_top7:
        x = torch.cat([x[..., :31], x[..., 31:] & 0x7F], dim=-1)
    diff = x - c
    pos = torch.arange(1, 33, dtype=torch.int16, device=b.device)
    top = ((diff != 0) * pos).argmax(-1, keepdim=True)   # 0 if all equal
    return torch.gather(diff, -1, top).squeeze(-1) < 0


def sc_from_bytes32(b: torch.Tensor):
    """(..., 32) uint8 -> (the bytes, canonical mask S < l). S is used
    unreduced; the reference rejects S >= l (malleability)."""
    return b, _bytes_lt(b, L)


# ---------------------------------------------------------------------------
# host-side (python int) curve arithmetic for the static tables
# ---------------------------------------------------------------------------

def _host_pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * fe.D2 % P * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (dd - c) % P, (dd + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _host_affine(p):
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def _host_sqrt_ratio(u: int, v: int):
    """x with v x^2 = u (mod p), or None."""
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if v * x * x % P == u % P:
        return x
    x = x * fe.SQRT_M1 % P
    if v * x * x % P == u % P:
        return x
    return None


def _basepoint():
    by = 4 * pow(5, P - 2, P) % P
    x = _host_sqrt_ratio((by * by - 1) % P, (fe.d * by * by + 1) % P)
    return (P - x if x % 2 else x, by)


BASEPOINT = _basepoint()


@functools.lru_cache(maxsize=None)
def _small_order_encodings() -> np.ndarray:
    """(n, 32) uint8: every 32-byte string that decodes (RFC 8032 rules)
    to a point of the 8-torsion subgroup: canonical y, plus y + p when it
    fits below 2^255, for each valid sign. Membership is exactly the
    reference's small-order rejection of A and R (verify_strict, ref:
    src/ballet/ed25519/fd_ed25519_user.c:195-201)."""
    def host_mul(k: int, pt):
        acc = (0, 1, 1, 0)
        while k:
            if k & 1:
                acc = _host_pt_add(acc, pt)
            pt = _host_pt_add(pt, pt)
            k >>= 1
        return acc

    torsion = None
    for y in range(2, 200):        # [l]Q has order dividing 8; need 8
        x = _host_sqrt_ratio((y * y - 1) % P, (fe.d * y * y + 1) % P)
        if x is None:
            continue
        t = host_mul(L, (x, y, 1, x * y % P))
        t2 = _host_pt_add(t, t)
        if _host_affine(_host_pt_add(t2, t2)) != (0, 1):
            torsion = t
            break
    encs = set()
    pt = (0, 1, 1, 0)
    for _ in range(8):
        ax, ay = _host_affine(pt)
        for yy in ([ay, ay + P] if ay < 19 else [ay]):
            for sign in ([0, 1] if ax != 0 else [0]):
                encs.add((yy | (sign << 255)).to_bytes(32, "little"))
        pt = _host_pt_add(pt, torsion)
    return np.stack([np.frombuffer(e, np.uint8) for e in sorted(encs)])


def is_small_order_encoding(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (...,) bool: encodes an 8-torsion point."""
    tab = torch.as_tensor(_small_order_encodings(), device=b.device)
    return (b.unsqueeze(-2) == tab).all(-1).any(-1)


@functools.lru_cache(maxsize=None)
def _fixed_base_table() -> np.ndarray:
    """(64, 16, 4, 10) int64 limbs: table[j][w] = (w 16^j) B, affine
    extended (x, y, 1, xy); w = 0 is the identity."""
    bx, by = BASEPOINT
    gj = (bx, by, 1, bx * by % P)
    tab = np.zeros((64, 16, 4, fe.NLIMB), np.int64)
    for j in range(64):
        acc = (0, 1, 1, 0)
        for w in range(16):
            ax, ay = _host_affine(acc) if w else (0, 1)
            for ci, cv in enumerate((ax, ay, 1, ax * ay % P)):
                tab[j, w, ci] = fe.int_to_limbs(cv)
            acc = _host_pt_add(acc, gj)
        gj = acc                      # 16 gj after the 16 adds
    return tab


# ---------------------------------------------------------------------------
# points: extended coordinates, precomputed-operand adds (the formulas of
# the fused kernel, pallas_ed.py pt_*)
# ---------------------------------------------------------------------------

def _identity(like):
    zero = torch.zeros_like(like)
    one = fe.const(ONE_LIMBS, like)
    return (zero, one, one, zero)


def _dbl(p, with_t: bool):
    """Doubling; without T (7 muls) when the result feeds a doubling."""
    x1, y1, z1, _ = p
    a = fe.sq(x1)
    b = fe.sq(y1)
    c = fe.mul2(fe.sq(z1))
    h = fe.add(a, b)
    e = fe.sub(h, fe.sq(fe.add(x1, y1)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
            fe.mul(e, h) if with_t else p[3])


def _add_tail(a, b, c, d):
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def _madd_aff(p, q):
    """p + q, q affine precomputed (Y-X, Y+X, 2dT) with Z = 1: 7 muls."""
    x1, y1, z1, t1 = p
    return _add_tail(fe.mul(fe.sub(y1, x1), q[0]),
                     fe.mul(fe.add(y1, x1), q[1]),
                     fe.mul(t1, q[2]), fe.mul2(z1))


def _add_pre(p, q):
    """p + q, q projective precomputed (Y-X, Y+X, 2Z, 2dT): 8 muls."""
    x1, y1, z1, t1 = p
    return _add_tail(fe.mul(fe.sub(y1, x1), q[0]),
                     fe.mul(fe.add(y1, x1), q[1]),
                     fe.mul(t1, q[3]), fe.mul(z1, q[2]))


def _add_full(p, q):
    """General extended add (9 muls)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    return _add_tail(fe.mul(fe.sub(y1, x1), fe.sub(y2, x2)),
                     fe.mul(fe.add(y1, x1), fe.add(y2, x2)),
                     fe.mul(fe.mul_const(t1, fe.D2_LIMBS), t2),
                     fe.mul2(fe.mul(z1, z2)))


def _to_pre(p):
    x, y, z, t = p
    return (fe.sub(y, x), fe.add(y, x), fe.mul2(z),
            fe.mul_const(t, fe.D2_LIMBS))


def _neg_table(x, y, t):
    """[w(-P) for w = 0..15], extended, for P = (x, y, 1, t): the
    identity, -P, then 14 affine precomputed adds of -P (the kernels'
    ge_neg_start and table loop)."""
    nx, nt = fe.neg(x), fe.neg(t)
    q = (fe.sub(y, nx), fe.add(y, nx), fe.mul_const(nt, fe.D2_LIMBS))
    ident = _identity(y)
    full = [ident, (nx, y, ident[1], nt)]
    for _ in range(14):
        full.append(_madd_aff(full[-1], q))
    return full


def _pre_table(full):
    """A _neg_table as precomputed entries; entry 0 is (1, 1, 2, 0)."""
    one, zero = full[0][1], full[0][0]
    return [(one, one, fe.mul2(one), zero)] + [_to_pre(p) for p in full[1:]]


def _recover_x(y, sign):
    """RFC 8032 5.1.3 on exact y limbs and the sign bit -> (x, ok).
    y < p is NOT checked here (the strict glue's byte compare does)."""
    one = fe.const(ONE_LIMBS, y)
    y2 = fe.sq(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul_const(y2, fe.D_LIMBS), one)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    vx2 = fe.mul(v, fe.sq(x))
    root_ok = fe.is_zero(fe.sub(vx2, u))
    root_neg = fe.is_zero(fe.add(vx2, u))
    x = torch.where(root_neg.unsqueeze(-1),
                    fe.mul_const(x, fe.SQRT_M1_LIMBS), x)
    xc = fe.canon(x)
    ok = (root_ok | root_neg) & ~((xc == 0).all(-1) & (sign == 1))
    flip = (xc[..., 0] & 1) != sign
    return torch.where(flip.unsqueeze(-1), fe.neg(x), x), ok


def _decode_xyt(b: torch.Tensor):
    """(..., 32) uint8 -> (x, y, t = xy, ok): the kernels' ge_decompress,
    that is decompress without its y < p byte compare."""
    y = fe.frombytes(b)
    x, ok = _recover_x(y, (b[..., 31] >> 7).to(torch.int64))
    return x, y, fe.mul(x, y), ok


def decompress(b: torch.Tensor):
    """(..., 32) uint8 -> ((x, y, 1, xy) limbs, ok). Rejects y >= p,
    non-square x^2 and x = 0 with the sign set."""
    sign = (b[..., 31] >> 7).to(torch.int64)
    y = fe.frombytes(b)
    x, ok = _recover_x(y, sign)
    ok = ok & _bytes_lt(b, P, mask_top7=True)
    return (x, y, fe.const(ONE_LIMBS, y), fe.mul(x, y)), ok


def sc_windows4(b: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 LE -> (..., 2n) int64 4-bit windows, LSB first."""
    x = b.to(torch.int64)
    return torch.stack([x & 15, x >> 4], dim=-1).flatten(-2)


def verify_core(sig: torch.Tensor, pub: torch.Tensor, k64: torch.Tensor,
                fb_tab: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused verify kernel (csrc/ed25519_verify.cu;
    JAX counterpart pallas_ed._verify_core): decompress A, k = k64 mod l,
    R' = [S]B + [k](-A) over 64 msb-first 4-bit windows, encode, compare
    with R. sig (B, 64), pub (B, 32), k64 (B, 64) uint8; fb_tab
    (64, 16, 3, 10) int32 (ops/params.py). Returns (B,) int32 verdicts
    (the glue's S/A/R canonicity and small-order masks not applied)."""
    rb, sb = sig[:, :32], sig[:, 32:]
    ax, ay, at, dec_ok = _decode_xyt(pub)
    kw = sc_windows4(sc_reduce64(k64))
    sw = sc_windows4(sb)
    tab = fb_tab.to(torch.int64)

    vbtab = _pre_table(_neg_table(ax, ay, at))
    vbtab = torch.stack([torch.stack(e, dim=1) for e in vbtab], dim=1)
    lanes = torch.arange(ay.shape[0], device=ay.device)

    ident = _identity(ay)
    vacc, facc = ident, ident
    for j in range(63, -1, -1):
        vacc = _dbl(_dbl(_dbl(vacc, False), False), False)
        vacc = _dbl(vacc, True)
        vacc = _add_pre(vacc, vbtab[lanes, kw[:, j]].unbind(1))
        facc = _madd_aff(facc, tab[j, sw[:, j]].unbind(1))
    rx, ry, rz, _ = _add_full(vacc, facc)

    zinv = fe.invert(rz)
    enc = fe.tobytes(fe.mul(ry, zinv))
    xsign = fe.canon(fe.mul(rx, zinv))[:, 0] & 1
    enc = torch.cat([enc[:, :31], enc[:, 31:] | (xsign << 7).to(
        torch.uint8).unsqueeze(-1)], dim=-1)
    match = (enc == rb).all(-1)
    return (dec_ok & match).to(torch.int32)


def strict_prechecks(sig: torch.Tensor, pub: torch.Tensor) -> torch.Tensor:
    """(B,) bool: S < l, A.y < p, A and R not small-order encodings (the
    strict verify's byte checks, pallas_ed.py:731-734; the SHA-512
    kernel's `pre`)."""
    return (_bytes_lt(sig[:, 32:], L) & _bytes_lt(pub, P, mask_top7=True)
            & ~is_small_order_encoding(pub)
            & ~is_small_order_encoding(sig[:, :32]))


def strict_verify(sig, pub, msg, msg_len, sha512_fn, core_fn):
    """The strict glue (counterpart of pallas_ed.verify_batch,
    pallas_ed.py:719-744) around its two kernels:
    `sha512_fn(sig, pub, msg, msg_len) -> (k64, pre)` reads R || A || M in
    place for k = SHA-512(R || A || M) and runs the prechecks
    (strict_prechecks, as int32), and `core_fn(sig, pub, k64)` the fused
    core. All tensors on one device; -> (B,) bool."""
    k64, pre = sha512_fn(sig, pub, msg, msg_len)
    return (pre & core_fn(sig, pub, k64)) != 0


def as_inputs(sig, pub, msg, msg_len, device):
    """Resolve `device` and move/convert (B, 64), (B, 32), (B, L) uint8
    and (B,) int32 inputs onto it (no copy for tensors already there)."""
    dev = _device.resolve(device)
    u8 = dict(dtype=torch.uint8, device=dev)
    return (torch.as_tensor(sig, **u8).contiguous(),
            torch.as_tensor(pub, **u8).contiguous(),
            torch.as_tensor(msg, **u8).contiguous(),
            torch.as_tensor(msg_len, dtype=torch.int32, device=dev))


def verify_batch(sig, pub, msg, msg_len, device="cuda"):
    """Batched strict verify, plain PyTorch throughout (no kernels).

    sig (B, 64), pub (B, 32), msg (B, L) uint8 (zero past each length),
    msg_len (B,) int32 -> (B,) bool on `device`."""
    from .params import fixed_base_tables
    from .sha2 import sha512_ram
    sig, pub, msg, msg_len = as_inputs(sig, pub, msg, msg_len, device)
    tab = fixed_base_tables(sig.device)
    return strict_verify(sig, pub, msg, msg_len, sha512_ram,
                         lambda s, p, k: verify_core(s, p, k, tab))


# ---------------------------------------------------------------------------
# RLC batch verification (the bulk pre-filter)
# ---------------------------------------------------------------------------

def rlc_prechecks(sig: torch.Tensor, pub: torch.Tensor) -> torch.Tensor:
    """(B,) bool: strict_prechecks and R.y < p (the byte-level part of
    an RLC lane's lane_ok)."""
    return strict_prechecks(sig, pub) & _bytes_lt(sig[:, :32], P,
                                                  mask_top7=True)


def rlc_verify(sig, pub, msg, msg_len, z_bytes, sha512_fn, stage1_fn,
               stage2_fn):
    """The RLC batch check around its three kernels (counterpart of the
    JAX rlc_verify_batch, ed25519.py:548-649, and of
    pallas_msm.rlc_verify_batch_tpu). Checks

        sum_i z_i ([S_i]B - [k_i]A_i - R_i) == identity

    over the lanes that pass lane_ok: S < l, A.y < p, R.y < p, A and R
    not small-order encodings, A and R decompress. z counts as zero on
    every other lane. `sha512_fn(sig, pub, msg, msg_len) -> (k64, pre)`
    forms k64 = SHA-512(R || A || M) from the rows in place (its strict
    `pre` is not used: stage 1 runs its own prechecks); stage 1
    (`stage1_fn(pub, sig, k64, z) -> (wsum, lane_ok, sdig)`) runs the
    prechecks, k = k64 mod l, z k and z S mod l, and
    stage 2 (`stage2_fn(wsum, sdig) -> (ok, point)`) folds the digit
    sums of z S into s = sum_i z_i S_i mod l.

    COFACTORED semantics, as the JAX function documents: a lane whose
    residual is a nonzero pure 8-torsion point is invisible when
    z_i = 0 mod 8, so the strict kernel stays the accept authority.

    All tensors on one device; -> (batch_ok () bool, lane_pre (B,) bool)."""
    if sig.shape[0] == 0:
        raise ValueError("rlc_verify: empty batch")
    k64, _ = sha512_fn(sig, pub, msg, msg_len)
    wsum, lane_ok, sdig = stage1_fn(pub, sig, k64, z_bytes)
    ok, _ = stage2_fn(wsum, sdig)
    return ok != 0, lane_ok != 0


def rlc_verify_batch(sig, pub, msg, msg_len, z_bytes, device="cuda"):
    """RLC batch verification, plain PyTorch throughout (no kernels).

    sig (B, 64), pub (B, 32), msg (B, L) uint8, msg_len (B,) int32,
    z_bytes (B, 16) uint8 random coefficients from the caller, secret
    from txn senders. -> (batch_ok () bool, lane_pre (B,) bool) on
    `device`: batch_ok means every lane_pre lane verified under the
    cofactored equation (whp); lane_pre False lanes are invalid."""
    from . import msm
    from .params import fixed_base_tables
    from .sha2 import sha512_ram
    sig, pub, msg, msg_len = as_inputs(sig, pub, msg, msg_len, device)
    z = torch.as_tensor(z_bytes, dtype=torch.uint8,
                        device=sig.device).contiguous()
    tab = fixed_base_tables(sig.device)
    return rlc_verify(sig, pub, msg, msg_len, z, sha512_ram, msm.msm_stage1,
                      lambda w, s: msm.msm_stage2(w, s, tab))


def verify_batch_rlc(sig, pub, msg, msg_len, rng=None, device="cuda"):
    """RLC fast path with strict fallback (the JAX verify_batch_rlc):
    lane_pre when the batch equation holds, else verify_batch's verdicts.
    Equal to verify_batch except on the torsion class rlc_verify
    documents. -> (B,) bool on `device`."""
    rng = rng or np.random.default_rng()
    z = rng.integers(0, 256, (sig.shape[0], 16), dtype=np.uint8)
    ok, lane_pre = rlc_verify_batch(sig, pub, msg, msg_len, z, device)
    if bool(ok):
        return lane_pre
    return verify_batch(sig, pub, msg, msg_len, device)
