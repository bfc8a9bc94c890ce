"""GF(2^255 - 19) in the verify kernel's own limb scheme, as plain PyTorch.

Scheme (ref10-style, chosen for Hopper's 32x32->64 multiplies): an
element is 10 signed limbs in radix 2^25.5. Limb i has weight
2^OFFSETS[i] and nominal width WIDTHS[i] (26 bits for even i, 25 for
odd). `csrc/ed25519_verify.cu` keeps a limb in an int32 and a product
sum in an int64; this module computes the SAME operations, in the same
order, on int64 tensors of shape (..., 10), so it is the plain version
that the kernel is held to, bit for bit.

Bound discipline. Every element that any primitive returns is "loose":
limb i lies in [LOOSE_LO[i], LOOSE_HI[i]]. Every primitive maps loose
inputs to loose outputs, every product sum fits an int64 and every
stored limb (and 19x a limb, the wrap multiplier) fits an int32.
`tests/test_torch_bounds.py` proves all of that by interval arithmetic
over the exact operation sequence below. The replaced TPU scheme
(radix 2^13 x 20 int32 limbs, wrap-tolerant `_reduce39`, pltpu.roll
products) is specific to the TPU's vector unit and is not mirrored.
"""
from __future__ import annotations

import torch

NLIMB = 10
P = (1 << 255) - 19
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
MASKS = tuple((1 << w) - 1 for w in WIDTHS)

# loose bound: the fixpoint proven closed in tests/test_torch_bounds.py
LOOSE_LO = (-(1 << 6),) * NLIMB
LOOSE_HI = tuple((1 << w) + (1 << 8) for w in WIDTHS)

d = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * d % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def int_to_limbs(x: int) -> tuple[int, ...]:
    """Canonical exact limbs of a non-negative integer < 2^255."""
    return tuple((x >> o) & m for o, m in zip(OFFSETS, MASKS))


def limbs_to_int(limbs) -> int:
    """Value (not reduced) of a limb vector; signed limbs allowed."""
    return sum(int(v) << o for v, o in zip(limbs, OFFSETS))


P_LIMBS = int_to_limbs(P)
# 2p limb by limb: neg(f) = carry(2p - f) keeps every raw limb positive
TWO_P_LIMBS = tuple(2 * v for v in P_LIMBS)
D_LIMBS = int_to_limbs(d)
D2_LIMBS = int_to_limbs(D2)
SQRT_M1_LIMBS = int_to_limbs(SQRT_M1)

# schoolbook index tables: h[k] = sum_i Fsel[k,i] * Gsel[k,i] with
# j = (k - i) mod 10; f_i doubled when i and j are both odd (weight
# 2^(O_i + O_j - O_k) = 2), g_j times 19 when i + j >= 10 (2^255 = 19)
_J = [[(k - i) % NLIMB for i in range(NLIMB)] for k in range(NLIMB)]
_ODDODD = [[bool(i & 1 and _J[k][i] & 1) for i in range(NLIMB)]
           for k in range(NLIMB)]
_WRAP = [[i > k for i in range(NLIMB)] for k in range(NLIMB)]
# the product carry order (two interleaved chains, ref10 fe_mul): each
# entry carries limb i into limb i+1 (limb 9 into limb 0 times 19)
MUL_CARRY_ORDER = (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0)

_tab_cache: dict = {}


def _tables(device):
    key = str(device)
    if key not in _tab_cache:
        _tab_cache[key] = (
            torch.tensor(_J, dtype=torch.int64, device=device),
            torch.tensor(_ODDODD, device=device),
            torch.tensor(_WRAP, device=device),
            torch.tensor(WIDTHS, dtype=torch.int64, device=device),
            torch.tensor(MASKS, dtype=torch.int64, device=device),
        )
    return _tab_cache[key]


def const(x_limbs, like: torch.Tensor) -> torch.Tensor:
    """A constant limb vector broadcast to `like`'s batch shape."""
    t = torch.tensor(x_limbs, dtype=torch.int64, device=like.device)
    return t.expand(like.shape[:-1] + (NLIMB,))


def carry(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: limb i keeps its low WIDTHS[i] bits
    (floor shift, so signed input is fine) and passes the rest to limb
    i+1; limb 9's carry re-enters limb 0 times 19."""
    _, _, _, w, m = _tables(h.device)
    c = h >> w
    r = h & m
    c_in = torch.cat([c[..., 9:] * 19, c[..., :9]], dim=-1)
    return r + c_in


def add(f, g):
    return carry(f + g)


def sub(f, g):
    return carry(f - g)


def neg(f):
    return carry(const(TWO_P_LIMBS, f) - f)


def mul2(f):
    return carry(2 * f)


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Schoolbook product with int64 sums, then the interleaved carry
    chain of MUL_CARRY_ORDER (floor shifts)."""
    j, oddodd, wrap, _, _ = _tables(f.device)
    fb = f.unsqueeze(-2)                              # (..., 1, 10)
    fsel = torch.where(oddodd, 2 * fb, fb)            # (..., 10, 10)
    gsel = torch.where(wrap, (19 * g)[..., j], g[..., j])
    h = list((fsel * gsel).sum(-1).unbind(-1))
    for i in MUL_CARRY_ORDER:
        c = h[i] >> WIDTHS[i]
        h[i] = h[i] - (c << WIDTHS[i])
        if i == 9:
            h[0] = h[0] + 19 * c
        else:
            h[i + 1] = h[i + 1] + c
    return torch.stack(h, dim=-1)


def sq(f):
    return mul(f, f)


def mul_const(f, c_limbs):
    return mul(f, const(c_limbs, f))


def _nsq(x, n):
    for _ in range(n):
        x = sq(x)
    return x


def _chain_z250(x):
    """x^(2^250 - 1) and x^11: shared prefix of the curve25519
    inversion and square-root addition chains."""
    x2 = sq(x)
    x9 = mul(x, sq(sq(x2)))
    x11 = mul(x2, x9)
    z5 = mul(x9, sq(x11))
    z10 = mul(_nsq(z5, 5), z5)
    z20 = mul(_nsq(z10, 10), z10)
    z40 = mul(_nsq(z20, 20), z20)
    z50 = mul(_nsq(z40, 10), z10)
    z100 = mul(_nsq(z50, 50), z50)
    z200 = mul(_nsq(z100, 100), z100)
    z250 = mul(_nsq(z200, 50), z50)
    return z250, x11


def pow_p58(x):
    """x^((p-5)/8) = x^(2^252 - 3)."""
    z250, _ = _chain_z250(x)
    return mul(_nsq(z250, 2), x)


def invert(x):
    """x^(p-2) = x^(2^255 - 21)."""
    z250, x11 = _chain_z250(x)
    return mul(_nsq(z250, 5), x11)


def _chain(h: list, fold: bool):
    """Sequential floor carry 0..9. fold: limb 9's carry re-enters limb
    0 times 19; else it is dropped (value taken mod 2^255)."""
    for i in range(NLIMB):
        c = h[i] >> WIDTHS[i]
        h[i] = h[i] - (c << WIDTHS[i])
        if i < 9:
            h[i + 1] = h[i + 1] + c
        elif fold:
            h[0] = h[0] + 19 * c


def canon(x: torch.Tensor) -> torch.Tensor:
    """Exact digits of x mod p, in [0, p), for loose x.

    Two folded chains leave exact digits of a value in [0, 2^255): for
    loose input the first chain's top carry is in [-1, 1], so the second
    chain's correction of d0 is at most 19 and can neither leave d0
    negative nor spill again (argued in full in the module's bounds
    test). Then q = [value + 19 >= 2^255] = [value >= p], and adding
    19q and dropping bit 255 subtracts p once (ref10 fe_tobytes)."""
    h = list(x.unbind(-1))
    _chain(h, fold=True)
    _chain(h, fold=True)
    q = (h[0] + 19) >> WIDTHS[0]
    for i in range(1, NLIMB):
        q = (h[i] + q) >> WIDTHS[i]
    h[0] = h[0] + 19 * q
    _chain(h, fold=False)
    return torch.stack(h, dim=-1)


def is_zero(x):
    return (canon(x) == 0).all(-1)


def frombytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 LE -> exact limbs of the low 255 bits (bit 255,
    the sign of x in a point encoding, is masked)."""
    b = b.to(torch.int64)
    b = torch.cat([b, torch.zeros_like(b[..., :4])], dim=-1)
    limbs = []
    for o, m in zip(OFFSETS, MASKS):
        a, r = divmod(o, 8)
        v = (b[..., a] | (b[..., a + 1] << 8) | (b[..., a + 2] << 16)
             | (b[..., a + 3] << 24) | (b[..., a + 4] << 32))
        limbs.append((v >> r) & m)                # limb 9 stops at bit 254
    return torch.stack(limbs, dim=-1)


def tobytes(x: torch.Tensor) -> torch.Tensor:
    """Loose limbs -> (..., 32) uint8 canonical LE encoding."""
    c = canon(x)
    out = []
    for i in range(32):
        v = torch.zeros_like(c[..., 0])
        for k, (o, w) in enumerate(zip(OFFSETS, WIDTHS)):
            lo, hi = max(8 * i, o), min(8 * i + 8, o + w)
            if lo < hi:
                v = v | (((c[..., k] >> (lo - o)) & ((1 << (hi - lo)) - 1))
                         << (lo - 8 * i))
        out.append(v)
    return torch.stack(out, dim=-1).to(torch.uint8)
