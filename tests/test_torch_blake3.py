"""The port's BLAKE3 and lthash (firedancer_tpu_torch/ops/blake3.py, the
plain versions of csrc/blake3.cu, and utils/blake3_ref.py, the port's
copy of the host oracle) against the JAX package's ops/blake3.py and
utils/blake3_ref.py, and the standard vectors. Exact: digests are bytes,
and lthash lanes integers. The port carries lthash lanes as int32 in
[0, 2^16); the reference as uint16: the values are compared."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import blake3 as jb3
from firedancer_tpu.utils import blake3_ref as jref
from firedancer_tpu_torch.ops import blake3 as b3
from firedancer_tpu_torch.ops import cuda_blake3
from firedancer_tpu_torch.utils import blake3_ref as ref
from torch_hash_cases import rows

VEC = os.path.join(os.path.dirname(__file__), "vectors",
                   "blake3_vectors.json")
# the block and chunk edges, and the two-chunk cap
LENS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2047, 2048)


@pytest.fixture(scope="module")
def edge_rows():
    """The edge rows through the reference (eager, as its own tests run
    it) and through the port's entry points on the CPU, once: the tests
    compare row by row."""
    msg, ln = rows(LENS, 2048, 5)
    jm, jl = jnp.asarray(msg), jnp.asarray(ln)
    return (msg, ln, np.asarray(jb3.blake3_batch(jm, jl)),
            np.asarray(jb3.lthash_batch(jm, jl)),
            b3.blake3_batch(msg, ln, device="cpu").numpy(),
            b3.lthash_batch(msg, ln, device="cpu").numpy())


def _vec_msg(v):
    return bytes(v["sz"]) if v["zeros"] else \
        bytes(i % 251 for i in range(v["sz"]))


def test_oracle_copy_standard_vectors():
    vecs = json.load(open(VEC))
    assert len(vecs) >= 20
    for v in vecs:
        assert ref.blake3(_vec_msg(v)).hex() == v["hash"], v["sz"]


def test_oracle_copy_matches_reference_oracle():
    rng = np.random.default_rng(3)
    for n in (0, 5, 64, 1024, 1025, 3000, 5000):
        m = rng.bytes(n)
        assert ref.blake3(m, 96) == jref.blake3(m, 96)
        assert ref.lthash(m) == jref.lthash(m)
    assert (ref.IV, ref.MSG_PERM, ref.CHUNK_LEN, ref.BLOCK_LEN) == \
        (jref.IV, jref.MSG_PERM, jref.CHUNK_LEN, jref.BLOCK_LEN)


@pytest.mark.parametrize("i", range(len(LENS)), ids=lambda i: str(LENS[i]))
def test_blake3_batch_matches_jax_and_oracle(edge_rows, i):
    msg, ln, want, _, got, _ = edge_rows
    np.testing.assert_array_equal(got[i], want[i])
    assert bytes(got[i]) == ref.blake3(bytes(msg[i, :ln[i]]))


@pytest.mark.parametrize("i", range(len(LENS)), ids=lambda i: str(LENS[i]))
def test_lthash_batch_matches_jax_and_oracle(edge_rows, i):
    msg, ln, _, want, _, got = edge_rows
    assert got.dtype == np.int32 and got.shape == (len(LENS), 1024)
    np.testing.assert_array_equal(got[i], want[i].astype(np.int32))
    np.testing.assert_array_equal(
        got[i], np.frombuffer(ref.lthash(bytes(msg[i, :ln[i]])), np.uint16))


def test_narrow_and_odd_width_rows():
    """Rows narrower than a chunk, and of a width that is no multiple of
    4: the same digests."""
    msg, ln = rows((0, 7, 64, 99, 131), 131, 8)
    got = b3.blake3_batch(msg, ln, device="cpu").numpy()
    lt = b3.lthash_batch(msg, ln, device="cpu").numpy()
    for i, n in enumerate(ln):
        assert bytes(got[i]) == ref.blake3(bytes(msg[i, :n]))
        np.testing.assert_array_equal(
            lt[i], np.frombuffer(ref.lthash(bytes(msg[i, :n])), np.uint16))


def test_padding_past_the_length_is_ignored():
    m = b"masked-tail"
    a = np.zeros((1, 256), np.uint8)
    a[0, :len(m)] = np.frombuffer(m, np.uint8)
    b = a.copy()
    b[0, len(m):] = 0xEE
    ln = np.array([len(m)], np.int32)
    assert bytes(b3.blake3_batch(a, ln, device="cpu")[0].numpy()) == \
        bytes(b3.blake3_batch(b, ln, device="cpu")[0].numpy()) == \
        ref.blake3(m)


@pytest.mark.parametrize("entry", ["blake3_batch", "lthash_batch"])
def test_row_wider_than_two_chunks_raises(entry):
    msg = np.zeros((2, 2049), np.uint8)
    ln = np.array([3, 2049], np.int32)
    with pytest.raises(ValueError, match="2048"):
        getattr(b3, entry)(msg, ln, device="cpu")
    with pytest.raises(ValueError, match="2048"):
        getattr(jb3, entry)(jnp.asarray(msg), jnp.asarray(ln))
    wrap = cuda_blake3.blake3 if entry == "blake3_batch" \
        else cuda_blake3.lthash
    with pytest.raises(ValueError, match="2048"):
        wrap(torch.from_numpy(msg), torch.from_numpy(ln))


def test_lthash_add_sub_reduce_wrap_mod_2_16():
    a = torch.tensor([[65535, 1, 0, 40000]], dtype=torch.int32)
    b = torch.tensor([[1, 65535, 1, 40000]], dtype=torch.int32)
    assert b3.lthash_add(a, b).tolist() == [[0, 0, 1, 14464]]
    assert b3.lthash_sub(a, b).tolist() == [[65534, 2, 65535, 0]]
    assert b3.lthash_reduce(torch.cat([a, b, a])).tolist() == \
        [(2 * 65535 + 1) % 65536, (1 + 65535 + 1) % 65536, 1,
         (3 * 40000) % 65536]
    # the same arithmetic as the reference's wrapping uint16
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 16, (5, 1024)).astype(np.uint16)
    y = rng.integers(0, 1 << 16, (5, 1024)).astype(np.uint16)
    tx, ty = (torch.from_numpy(v.astype(np.int32)) for v in (x, y))
    np.testing.assert_array_equal(
        b3.lthash_add(tx, ty).numpy(),
        np.asarray(jb3.lthash_add(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(
        b3.lthash_sub(tx, ty).numpy(),
        np.asarray(jb3.lthash_sub(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(
        b3.lthash_reduce(tx).numpy(),
        np.asarray(jb3.lthash_reduce(jnp.asarray(x))))


def test_lthash_homomorphism():
    """(a + b + c) - b == a + c, wrapping; reduce is order-independent
    (tests/test_blake3.py:71)."""
    rng = np.random.default_rng(7)
    msgs = [rng.bytes(40), rng.bytes(1200), b""]
    arr = np.zeros((3, 2048), np.uint8)
    lens = np.array([len(m) for m in msgs], np.int32)
    for i, m in enumerate(msgs):
        arr[i, :len(m)] = np.frombuffer(m, np.uint8)
    vals = b3.lthash_batch(arr, lens, device="cpu")
    acc = torch.zeros(1024, dtype=torch.int32)
    for v in vals:
        acc = b3.lthash_add(acc, v)
    acc = b3.lthash_sub(acc, vals[1])
    assert torch.equal(acc, (vals[0] + vals[2]) & 0xFFFF)
    assert torch.equal(b3.lthash_reduce(vals),
                       b3.lthash_reduce(vals.flip(0)))


def test_wrappers_take_plain_path_for_cpu_tensors():
    msg, ln = rows((0, 70, 1100), 1100, 9)
    before = dict(cuda_blake3.launches)
    d = cuda_blake3.blake3(torch.from_numpy(msg), torch.from_numpy(ln))
    lt = cuda_blake3.lthash(torch.from_numpy(msg), torch.from_numpy(ln))
    assert cuda_blake3.launches == before
    for i, n in enumerate(ln):
        assert bytes(d[i].numpy()) == ref.blake3(bytes(msg[i, :n]))
        assert bytes(lt[i].numpy().astype(np.uint16)) == \
            ref.lthash(bytes(msg[i, :n]))


@pytest.mark.parametrize("entry", ["blake3_batch", "lthash_batch"])
def test_entry_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    msg, ln = rows((1,), 8, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(b3, entry)(msg, ln)
