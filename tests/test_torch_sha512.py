"""The port's plain SHA-512 (firedancer_tpu_torch/ops/sha2.py, the plain
version of csrc/sha512.cu) against the JAX package's ops/sha2.sha512 and
hashlib. Exact: digests are bytes."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu.ops import pallas_ed as jpe
from firedancer_tpu.ops import sha2 as jsha2
from firedancer_tpu_torch.ops import cuda_sha
from firedancer_tpu_torch.ops import ed25519 as ed
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
    before = dict(cuda_sha.launches)
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


def test_sha512_ram_matches_jax_glue():
    """sha2.sha512_ram (the plain version of the kernel's in-place entry)
    against the JAX strict glue of pallas_ed.verify_batch: k64 =
    sha2.sha512 of the R || A || M concat over msg_len + 64 bytes, and
    the prechecks S < l, A.y < p, A and R not small-order. B = 16: the
    padding edges and one lane per precheck class."""
    rng = np.random.default_rng(12)
    lens = [0, 47, 48, 111, 112, 175, 176, 1232] \
        + [int(x) for x in rng.integers(0, 1233, 8)]
    msg, ln = _batch(lens, 13)
    msg = msg[:, :1232]
    sig = rng.integers(0, 256, (16, 64), np.uint8)
    pub = rng.integers(0, 256, (16, 32), np.uint8)
    sig[:, 63] &= 0x0F                                  # S < l
    pub[:, 31] &= 0x7F                                  # A.y < p
    sig[1, 32:] = np.frombuffer(ed.L.to_bytes(32, "little"), np.uint8)
    sig[2, 32:] = np.frombuffer((ed.L - 1).to_bytes(32, "little"), np.uint8)
    pub[3] = 0xFF                                       # A.y >= p
    pub[4] = ed._small_order_encodings()[2]
    sig[5, :32] = ed._small_order_encodings()[7]
    k64, pre = sha2.sha512_ram(*(torch.from_numpy(x)
                                 for x in (sig, pub, msg, ln)))
    j = [jnp.asarray(x) for x in (sig, pub, msg, ln)]
    jk = jsha2.sha512(jnp.concatenate([j[0][:, :32], j[1], j[2]], axis=-1),
                      j[3] + 64)
    jpre = (jpe._bytes_lt(j[0][:, 32:], jed.L)
            & jpe._bytes_lt(j[1], jpe.fe.P, mask_top7=True)
            & ~jed.is_small_order_encoding(j[1])
            & ~jed.is_small_order_encoding(j[0][:, :32]))
    np.testing.assert_array_equal(k64.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
    assert pre.dtype == torch.int32
    assert pre.tolist() == [int(i not in (1, 3, 4, 5)) for i in range(16)]
