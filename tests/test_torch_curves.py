"""The port's host curve code behind the curve and alt_bn128 syscalls
(firedancer_tpu_torch/utils/ristretto.py, utils/bn254.py) against the JAX
package's, on the cases of tests/test_ristretto.py and tests/test_bn254.py
and seeded scalars: every encoding, decoding, group operation, pairing
check and precompile output equal, and every rejection the same."""
import random

import pytest

from firedancer_tpu.utils import bn254 as jbn
from firedancer_tpu.utils import ristretto as jrr
from firedancer_tpu_torch.utils import bn254 as tbn
from firedancer_tpu_torch.utils import ristretto as trr
from firedancer_tpu_torch.utils.ed25519_ref import L

RNG = random.Random(19)
SCALARS = [1, 2, 3, 7, 100, L - 1, L] + [RNG.randrange(L) for _ in range(4)]


def test_ristretto_matches_reference():
    for n in SCALARS:
        enc = [m.encode(m.mul(n, m.base())) for m in (jrr, trr)]
        assert enc[1] == enc[0]
        p = trr.decode(enc[1])
        assert p is not None and trr.encode(p) == enc[1]
        q = jrr.decode(enc[0])
        a = trr.encode(trr.add(p, trr.base()))
        assert a == jrr.encode(jrr.add(q, jrr.base()))
        assert trr.validate(enc[1]) == jrr.validate(enc[0])
    # RFC 9496 A.1: the generator's first multiples
    assert trr.encode(trr.mul(2, trr.base())).hex() == (
        "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919")


@pytest.mark.parametrize("bad", [
    b"\x01" + bytes(31), b"\xff" * 32, bytes(16), bytes(32),
    bytes(jrr.encode(jrr.base())[:31]) + b"\x80",
] + [bytes(RNG.randrange(256) for _ in range(32)) for _ in range(6)])
def test_ristretto_decode_matches_reference(bad):
    got = [m.decode(bad) for m in (jrr, trr)]
    assert (got[1] is None) == (got[0] is None)
    if got[1] is not None:
        assert trr.encode(got[1]) == jrr.encode(got[0])
    assert trr.validate(bad) == jrr.validate(bad)


def _enc_g2(pt):
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))


def test_bn254_g1_matches_reference():
    assert tbn.G1_GEN == jbn.G1_GEN and tbn.G2_GEN == jbn.G2_GEN
    assert tbn.R == jbn.R and tbn.P == jbn.P
    for n in SCALARS[:6]:
        for fn, args in (("g1_mul", (n, tbn.G1_GEN)),
                         ("g1_add", (tbn.g1_mul(n, tbn.G1_GEN),
                                     tbn.G1_GEN)),
                         ("g1_neg", (tbn.g1_mul(n, tbn.G1_GEN),))):
            assert getattr(tbn, fn)(*args) == getattr(jbn, fn)(*args)
    g = tbn.G1_GEN
    for data in (tbn.enc_g1(g) + tbn.enc_g1(g),
                 tbn.enc_g1(g) + tbn.enc_g1(tbn.g1_neg(g)),
                 bytes(128), tbn.enc_g1(g)):
        assert tbn.alt_bn128_add(data) == jbn.alt_bn128_add(data)
        assert tbn.alt_bn128_sub(data) == jbn.alt_bn128_sub(data)
    for s in (0, 5, tbn.R, tbn.R + 5, (1 << 256) - 1):
        data = tbn.enc_g1(g) + s.to_bytes(32, "big")
        assert tbn.alt_bn128_mul(data) == jbn.alt_bn128_mul(data)


@pytest.mark.parametrize("bad", [
    (1).to_bytes(32, "big") * 2,                  # off the curve
    jbn.P.to_bytes(32, "big") + bytes(32),        # non-canonical x
    bytes(63),                                    # short, padded
])
def test_bn254_rejections_match_reference(bad):
    outs = []
    for m in (jbn, tbn):
        try:
            outs.append(m.alt_bn128_add(bad + bytes(64)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[1] == outs[0]


def test_bn254_pairing_matches_reference():
    """EIP-197: e(2P, 3Q) e(-6P, Q) == 1, a failing pair, the empty
    input; the G2 subgroup check."""
    g1, g2 = tbn.G1_GEN, tbn.G2_GEN
    good = (tbn.enc_g1(tbn.g1_mul(2, g1)) + _enc_g2(tbn.g2_mul(3, g2))
            + tbn.enc_g1(tbn.g1_neg(tbn.g1_mul(6, g1))) + _enc_g2(g2))
    bad = tbn.enc_g1(g1) + _enc_g2(g2)
    for data in (good, bad, b""):
        assert tbn.alt_bn128_pairing(data) == jbn.alt_bn128_pairing(data)
    assert tbn.alt_bn128_pairing(good)[-1] == 1
    assert tbn.alt_bn128_pairing(bad)[-1] == 0
    assert tbn.g2_in_subgroup(g2) == jbn.g2_in_subgroup(g2) is True
