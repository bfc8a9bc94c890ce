"""Interval-arithmetic proof of the verify kernel's limb bounds.

The port's field scheme (firedancer_tpu_torch/ops/fe25519.py, mirrored
limb for limb by csrc/ed25519_verify.cu) keeps every element "loose":
limb i in [LOOSE_LO[i], LOOSE_HI[i]], signed, radix 2^25.5. The kernel
stores a limb in an int32 and a product sum in an int64, so this file
walks the exact operation sequence of every primitive over intervals
and shows:

  1. each primitive (add, sub, neg, mul2, mul, mul by a constant, the
     carries inside them) maps loose limbs to loose limbs (closure: any
     composition of primitives stays loose);
  2. every value the kernel holds in an int32 fits an int32 (raw sums
     before a carry, 2f and 19g inside the product, the canonicalising
     chains), and no int64 product sum can overflow;
  3. canon's first chain ends with a top carry in [-1, 1], the premise
     of its exactness argument; corner inputs then check canon against
     Python integers.

Random differential tests cannot reach the worst cases; the walk (in the
style of tests/test_pallas_bounds.py) covers every input in the bound.
"""
import itertools

import numpy as np
import torch

from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import fe25519 as fe

W = fe.WIDTHS
LOOSE = [(lo, hi) for lo, hi in zip(fe.LOOSE_LO, fe.LOOSE_HI)]
I32 = (-2 ** 31, 2 ** 31 - 1)
I64 = (-2 ** 63, 2 ** 63 - 1)


def fits(iv, rng):
    return rng[0] <= iv[0] and iv[1] <= rng[1]


def within(a, b):
    return all(fits(x, y) for x, y in zip(a, b))


def add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def scale(a, k):
    return (min(a[0] * k, a[1] * k), max(a[0] * k, a[1] * k))


def mul(a, b):
    c = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
    return (min(c), max(c))


def shr(a, w):
    return (a[0] >> w, a[1] >> w)


def low(a, w):
    """Interval of a & (2^w - 1) (== a - (a >> w << w))."""
    m = (1 << w) - 1
    if a[0] >> w == a[1] >> w:
        return (a[0] & m, a[1] & m)
    return (0, m)


def carry_iv(h, raw_type=I32):
    """fe25519.carry over raw-sum intervals: raw sums live in an int32
    in the kernel (fe_carry), and so does 19 * c9."""
    for x in h:
        assert fits(x, raw_type), f"raw sum {x} overflows"
    c = [shr(x, w) for x, w in zip(h, W)]
    r = [low(x, w) for x, w in zip(h, W)]
    out = [add(r[0], scale(c[9], 19))]
    out += [add(r[i], c[i - 1]) for i in range(1, 10)]
    for x in out:
        assert fits(x, I32)
    return out


def mul_iv(f, g):
    """fe25519.mul / fe_mul: 2f and 19g in int32, int64 sums, then the
    interleaved int64 carry chain; the result is stored as int32."""
    f2 = [scale(x, 2) for x in f]
    g19 = [scale(x, 19) for x in g]
    for x in f2 + g19:
        assert fits(x, I32), f"2f / 19g {x} overflows int32"
    h = [(0, 0)] * 10
    for i in range(10):
        for j in range(10):
            a = f2[i] if (i & 1 and j & 1) else f[i]
            b = g19[j] if i + j >= 10 else g[j]
            k = (i + j) % 10
            h[k] = add(h[k], mul(a, b))
            assert fits(h[k], I64), f"product sum {h[k]} overflows int64"
    for i in fe.MUL_CARRY_ORDER:
        c = shr(h[i], W[i])
        h[i] = low(h[i], W[i])
        if i == 9:
            h[0] = add(h[0], scale(c, 19))
        else:
            h[i + 1] = add(h[i + 1], c)
        assert all(fits(x, I64) for x in h)
    for x in h:
        assert fits(x, I32), f"mul output limb {x} overflows int32"
    return h


def exact_digits():
    return [(0, (1 << w) - 1) for w in W]


def test_loose_bound_contains_exact_inputs():
    """frombytes limbs, canonical constants and fixed-base table
    entries are exact digits, inside the loose bound."""
    assert within(exact_digits(), LOOSE)


def test_add_sub_neg_mul2_closure():
    for op in (lambda a, b: add(a, b),
               lambda a, b: (a[0] - b[1], a[1] - b[0])):
        out = carry_iv([op(a, b) for a, b in zip(LOOSE, LOOSE)])
        assert within(out, LOOSE), out
    assert within(carry_iv([(t - hi, t - lo) for t, (lo, hi)
                            in zip(fe.TWO_P_LIMBS, LOOSE)]), LOOSE)
    assert within(carry_iv([scale(x, 2) for x in LOOSE]), LOOSE)


def test_mul_closure_and_int64_headroom():
    out = mul_iv(LOOSE, LOOSE)
    assert within(out, LOOSE), out
    # the worst product sum, for the record: well inside int64
    worst = max(abs(lo) * abs(hi) for lo, hi in LOOSE)
    assert 10 * 38 * worst < 2 ** 63


def test_mul_const_closure():
    assert within(mul_iv(LOOSE, exact_digits()), LOOSE)
    assert within(mul_iv(exact_digits(), LOOSE), LOOSE)


def test_canon_first_chain_top_carry():
    """canon's premise: after the first folded chain over a loose input,
    limb 9's carry is in [-1, 1] (so the second chain adjusts d0 by at
    most 19), and every chain value fits an int32."""
    h = list(LOOSE)
    for i in range(10):
        assert fits(h[i], I32)
        c = shr(h[i], W[i])
        h[i] = low(h[i], W[i])
        if i < 9:
            h[i + 1] = add(h[i + 1], c)
    assert -1 <= c[0] and c[1] <= 1, c


def _corners(n=256, seed=3):
    """Loose vectors at the bound's corners: every limb at its low or
    high end (a seeded sample of the 2^10 patterns, plus the all-low,
    all-high and alternating ones)."""
    rng = np.random.default_rng(seed)
    pats = [(0,) * 10, (1,) * 10, (0, 1) * 5, (1, 0) * 5]
    pats += [tuple(rng.integers(0, 2, 10)) for _ in range(n)]
    return torch.tensor([[LOOSE[i][p[i]] for i in range(10)] for p in pats],
                        dtype=torch.int64)


def test_corners_canon_and_mul_exact():
    x = _corners()
    c = fe.canon(x)
    y = fe.mul(x, x.flip(0))
    s = fe.sub(x, x.flip(0))
    for i in range(x.shape[0]):
        v = fe.limbs_to_int(x[i])
        assert fe.limbs_to_int(c[i]) == v % fe.P
        assert all(0 <= int(d) < (1 << w) for d, w in zip(c[i], W))
        vf = fe.limbs_to_int(x[-1 - i])
        assert fe.limbs_to_int(y[i]) % fe.P == v * vf % fe.P
        assert fe.limbs_to_int(s[i]) % fe.P == (v - vf) % fe.P
    for t in (y, s):
        assert bool(((t >= torch.tensor(fe.LOOSE_LO))
                     & (t <= torch.tensor(fe.LOOSE_HI))).all())


def test_sc_reduce64_sums_fit_int64_and_corners():
    """The scalar fold keeps every sum far inside int64 (interval walk
    over 21-bit digits, the top one 29 bits), and the extreme hashes
    reduce exactly."""
    s = [(0, (1 << 21) - 1)] * 23 + [(0, (1 << 29) - 1)]

    def fold(n):
        for m, cst in enumerate(ed.SC_C):
            s[n - 12 + m] = add(s[n - 12 + m], scale(s[n], cst))
        s[n] = (0, 0)

    def carry21(lo, hi):
        for i in range(lo, hi):
            c = shr(s[i], 21)
            s[i] = low(s[i], 21)
            s[i + 1] = add(s[i + 1], c)

    for n in range(23, 17, -1):
        fold(n)
    carry21(6, 17)
    for n in range(17, 11, -1):
        fold(n)
    carry21(0, 12)
    assert all(abs(lo) < 2 ** 62 and abs(hi) < 2 ** 62 for lo, hi in s)
    assert -(1 << 12) < s[12][0] and s[12][1] < (1 << 12), s[12]
    vals = [bytes(64), b"\xff" * 64, ed.L.to_bytes(64, "little"),
            (ed.L - 1).to_bytes(64, "little"),
            (2 * ed.L).to_bytes(64, "little"),
            ((1 << 252) + 1).to_bytes(64, "little")]
    vals += [bytes(b) for b in itertools.islice(
        np.random.default_rng(4).integers(0, 256, (32, 64), np.uint8), 32)]
    got = ed.sc_reduce64(torch.tensor(np.frombuffer(b"".join(vals),
                                                    np.uint8).reshape(-1, 64)))
    for v, g in zip(vals, got):
        assert int.from_bytes(bytes(g.numpy()), "little") == \
            int.from_bytes(v, "little") % ed.L
