"""The port's plain SHA-512 (firedancer_tpu_torch/ops/sha2.py, the plain
version of csrc/sha512.cu) against the JAX package's ops/sha2.sha512 and
hashlib. Exact: digests are bytes."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sha2 as jsha2
from firedancer_tpu_torch.ops import cuda_sha
from firedancer_tpu_torch.ops import sha2

EDGE = [0, 1, 111, 112, 127, 128, 239, 240, 1296]
MAX_LEN = 1296


def _batch(lens, seed):
    rng = np.random.default_rng(seed)
    msg = np.zeros((len(lens), MAX_LEN), np.uint8)
    for i, n in enumerate(lens):
        msg[i, :n] = rng.integers(0, 256, n)
    return msg, np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", ["edges", "random"])
def test_sha512_matches_jax_and_hashlib(case):
    """B = 16: the padding edges (len % 128 in 112..127 spills into an
    extra block) plus random lengths."""
    rng = np.random.default_rng(7)
    lens = EDGE + [int(x) for x in rng.integers(0, MAX_LEN + 1, 7)] \
        if case == "edges" else \
        [int(x) for x in rng.integers(0, MAX_LEN + 1, 16)]
    msg, ln = _batch(lens, 8 if case == "edges" else 9)
    got = sha2.sha512(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    want = np.asarray(jsha2.sha512(jnp.asarray(msg), jnp.asarray(ln)))
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(ln):
        assert bytes(got[i]) == hashlib.sha512(bytes(msg[i, :n])).digest()


def test_wrapper_takes_plain_path_for_cpu_tensors():
    msg, ln = _batch([0, 5, 200, 1296], 10)
    before = cuda_sha.launches
    got = cuda_sha.sha512(torch.from_numpy(msg), torch.from_numpy(ln))
    assert cuda_sha.launches == before        # no kernel on the CPU
    for i, n in enumerate(ln):
        assert bytes(got[i].numpy()) == \
            hashlib.sha512(bytes(msg[i, :n])).digest()


def test_pad_message_layout_matches_jax():
    msg, ln = _batch([0, 111, 112, 127, 128, 300], 11)
    nblock = int(sha2.nblocks(MAX_LEN))
    buf, nb = sha2._pad_message(torch.from_numpy(msg),
                                torch.from_numpy(ln), nblock)
    jbuf, jnb = jsha2._pad_message(jnp.asarray(msg), jnp.asarray(ln),
                                   nblock, 128, 16)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
