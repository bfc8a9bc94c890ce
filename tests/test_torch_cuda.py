"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`: these need an NVIDIA card and skip without one. This file
imports neither jax nor the JAX package, so on a machine with a card and
no JAX it runs alone, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Exact: digests and verdicts are integers."""
import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import cuda_ed, cuda_sha, params, sha2
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.utils import ed25519_ref as ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _signed(n, msg_len, seed):
    rng = np.random.default_rng(seed)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = rng.integers(0, 256, (n, msg_len), np.uint8)
    for i in range(n):
        key = rng.bytes(32)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, msg[i].tobytes()), np.uint8)
        if i % 4 == 1:
            sig[i, 0] ^= 1
        elif i % 4 == 2:
            msg[i, -1] ^= 1
    pub[n - 1] = ed._small_order_encodings()[1]
    return sig, pub, msg, np.full(n, msg_len, np.int32)


@pytest.mark.parametrize("width", [1296, 1233])
def test_sha512_kernel_matches_plain(dev, width):
    """Aligned (1296) and unaligned (1233) row strides, padding edges."""
    rng = np.random.default_rng(51)
    lens = np.array([0, 1, 111, 112, 127, 128, 239, 240, width]
                    + list(rng.integers(0, width + 1, 300)), np.int32)
    msg = rng.integers(0, 256, (len(lens), width), np.uint8)
    m, ln = torch.from_numpy(msg).to(dev), torch.from_numpy(lens).to(dev)
    before = cuda_sha.launches
    got = cuda_sha.sha512(m, ln)
    assert cuda_sha.launches == before + 1
    plain = sha2.sha512(m, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    for i in (0, 3, 8, len(lens) - 1):
        assert bytes(got[i].cpu().numpy()) == \
            hashlib.sha512(bytes(msg[i, :lens[i]])).digest()


def test_verify_kernel_matches_plain(dev):
    sig, pub, msg, ln = _signed(48, 100, 52)
    k64 = np.stack([np.frombuffer(hashlib.sha512(
        bytes(sig[i, :32]) + bytes(pub[i]) + bytes(msg[i])).digest(),
        np.uint8) for i in range(len(sig))])
    s, p, k = (torch.from_numpy(x).to(dev) for x in (sig, pub, k64))
    before = cuda_ed.launches
    got = cuda_ed.verify_core(s, p, k)
    assert cuda_ed.launches == before + 1
    want = ed.verify_core(s, p, k, params.fixed_base_tables(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


def test_verify_batch_on_card_matches_cpu(dev):
    sig, pub, msg, ln = _signed(40, 64, 53)
    got = cuda_ed.verify_batch(sig, pub, msg, ln, device="cuda")
    want = cuda_ed.verify_batch(sig, pub, msg, ln, device="cpu")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def test_wrappers_refuse_bad_tensors(dev):
    m = torch.zeros((4, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        cuda_sha.sha512(m, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        cuda_sha.sha512(m.t(), torch.zeros(64, dtype=torch.int32,
                                            device=dev))
    with pytest.raises(ValueError):
        cuda_ed.verify_core(m, m[:, :31], m)
