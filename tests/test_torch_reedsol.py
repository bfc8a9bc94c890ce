"""The port's Reed-Solomon (firedancer_tpu_torch/ops/reedsol.py, one bit-
matrix product in torch.matmul) and its copy of the GF(2^8) oracle
(utils/gf256.py) against the JAX package's ops/reedsol.py and
utils/gf256.py, at the (d, p) pairs of tests/test_reedsol.py and 67:67.
Exact: parity and recovered shreds are bytes."""
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import reedsol as jrs
from firedancer_tpu.utils import gf256 as jgf
from firedancer_tpu_torch.ops import reedsol
from firedancer_tpu_torch.utils import gf256

PAIRS = [(32, 32), (16, 4), (8, 8), (67, 67)]


@pytest.mark.parametrize("d,p", PAIRS)
def test_encode_matches_jax_and_oracle(d, p):
    rng = np.random.default_rng(d * 100 + p)
    data = rng.integers(0, 256, (d, 64), np.uint8)
    got = reedsol.encode(data, p, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jrs.encode(data, p)))
    np.testing.assert_array_equal(got, gf256.encode(data, p))


@pytest.mark.parametrize("d,p", PAIRS)
def test_recover_matches_jax_and_data(d, p):
    """Erase every other shred of the first 2p positions (capped at p
    erasures), batched over 3 sets."""
    rng = np.random.default_rng(d + p)
    data = rng.integers(0, 256, (3, d, 48), np.uint8)
    par = reedsol.encode(data, p, device="cpu").numpy()
    missing = set(range(0, 2 * p, 2)[:p])
    present = tuple(sorted(set(range(d + p)) - missing)[:d])
    surv = np.concatenate([data, par], axis=1)[:, list(present), :]
    got = reedsol.recover(surv, present, d, p, device="cpu").numpy()
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(
        got, np.asarray(jrs.recover(surv, present, d, p)))


def test_encode_batched_shredder_region():
    """Four 32:32 sets over the shredder's RS region of a merkle data
    shred with 6 proof nodes (payload 995 + header 0x58 - signature 64 =
    1019 bytes): each set's parity equals the oracle's."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (4, 32, 1019), np.uint8)
    got = reedsol.encode(torch.from_numpy(data), 32, device="cpu")
    assert got.shape == (4, 32, 1019) and got.dtype == torch.uint8
    for s in range(4):
        np.testing.assert_array_equal(got[s].numpy(),
                                      gf256.encode(data[s], 32))


@pytest.mark.parametrize("d,p", PAIRS)
def test_bit_matrix_equals_reference(d, p):
    np.testing.assert_array_equal(reedsol._parity_bit_matrix(d, p),
                                  jrs._parity_bit_matrix(d, p))


def test_gf256_copy_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(0, 256, 2))
        assert gf256.gf_mul(a, b) == jgf.gf_mul(a, b)
        if b:
            assert gf256.gf_div(a, b) == jgf.gf_div(a, b)
    for d, p in PAIRS[:3]:
        np.testing.assert_array_equal(gf256.parity_matrix(d, p),
                                      jgf.parity_matrix(d, p))
    present = [0, 2, 3, 5]
    np.testing.assert_array_equal(gf256.recovery_matrix(4, 2, present),
                                  jgf.recovery_matrix(4, 2, present))


def test_encode_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        reedsol.encode(np.zeros((4, 8), np.uint8), 2)


@pytest.mark.parametrize("d,p", PAIRS[:3] + [(1, 17), (3, 2)])
def test_gf256_table_path_matches_reference(d, p):
    """The table lookups of the port's oracle (mat_mul, mat_inv, encode,
    recover) against the reference's one product a call, on random data
    and every shred position erased once."""
    rng = np.random.default_rng(7 * d + p)
    a = rng.integers(0, 256, (d, d), np.uint8)
    b = rng.integers(0, 256, (d, 5), np.uint8)
    np.testing.assert_array_equal(gf256.mat_mul(a, b), jgf.mat_mul(a, b))
    data = rng.integers(0, 256, (d, 33), np.uint8)
    par = gf256.encode(data, p)
    np.testing.assert_array_equal(par, jgf.encode(data, p))
    words = np.concatenate([data, par])
    for gone in range(d + p):
        kept = {i: words[i] for i in range(d + p) if i != gone}
        present = sorted(kept)[:d]
        np.testing.assert_array_equal(
            gf256.recovery_matrix(d, p, present),
            jgf.recovery_matrix(d, p, present))
        np.testing.assert_array_equal(gf256.recover(kept, d, p), data)
