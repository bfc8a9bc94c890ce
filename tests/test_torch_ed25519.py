"""The port's plain ed25519 pieces (firedancer_tpu_torch/ops/ed25519.py)
against the JAX package's ops/ed25519.py on the same numpy inputs.
Exact: scalars, coordinates and verdicts are integers and booleans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu.ops import fe25519 as jfe
from firedancer_tpu.utils import ed25519_ref as jref
from firedancer_tpu_torch.ops import cuda_ed
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import fe25519 as fe


def _jdigits_to_int(d):
    return sum(int(v) << (13 * i) for i, v in enumerate(d))


def mixed_batch(n, msg_len, seed):
    """Valid signatures with a spread of corruptions (modelled on
    tests/test_pallas_ed.py::_mixed_batch) plus the structural edge
    cases: small-order A, small-order R, S >= l."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = np.zeros((n, msg_len), np.uint8)
    for i in range(n):
        key = rng.bytes(32)
        _, _, pk = jref.keypair(key)
        m = rng.bytes(msg_len)
        s = jref.sign(key, m)
        if i % 5 == 1:
            s = bytes([s[0] ^ 1]) + s[1:]                # corrupt R
        elif i % 5 == 2:
            s = s[:32] + bytes([s[32] ^ 1]) + s[33:]     # corrupt S
        elif i % 5 == 3:
            m = m[:-1] + bytes([m[-1] ^ 0x80])           # corrupt msg
        elif i % 5 == 4 and i % 2 == 0:
            pk = bytes([pk[0] ^ 1]) + pk[1:]             # corrupt A
        sig[i] = np.frombuffer(s, np.uint8)
        pub[i] = np.frombuffer(pk, np.uint8)
        msg[i] = np.frombuffer(m, np.uint8)
    small = jed._small_order_encodings()
    pub[n - 3] = small[1]                                 # small-order A
    sig[n - 2, :32] = small[2]                            # small-order R
    sig[n - 1, 32:] = np.frombuffer((jed.L + 5).to_bytes(32, "little"),
                                    np.uint8)             # S >= l
    return sig, pub, msg, np.full(n, msg_len, np.int32)


def _point_bytes(rng):
    """Valid keys, small-order encodings, y >= p, and random strings."""
    out = [np.frombuffer(jref.keypair(rng.bytes(32))[2], np.uint8)
           for _ in range(6)]
    out += list(jed._small_order_encodings()[:6])
    for v in (jfe.P, jfe.P + 1, (1 << 255) - 1, jfe.P | (1 << 255)):
        out.append(np.frombuffer((v % (1 << 256)).to_bytes(32, "little"),
                                 np.uint8))
    out += list(rng.integers(0, 256, (16, 32), np.uint8))
    return np.stack(out)


def test_sc_reduce64_matches_jax():
    rng = np.random.default_rng(21)
    b = rng.integers(0, 256, (32, 64), np.uint8)
    b[0], b[1] = 0xFF, 0
    got = ed.sc_reduce64(torch.from_numpy(b)).numpy()
    want = np.asarray(jax.jit(jed.sc_reduce64)(jnp.asarray(b)))
    for i in range(len(b)):
        assert int.from_bytes(bytes(got[i]), "little") == \
            _jdigits_to_int(want[i])


def test_sc_from_bytes32_mask_matches_jax():
    rng = np.random.default_rng(22)
    b = rng.integers(0, 256, (24, 32), np.uint8)
    for i, v in enumerate((jed.L, jed.L - 1, jed.L + 1, 0)):
        b[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    _, got = ed.sc_from_bytes32(torch.from_numpy(b))
    _, want = jed.sc_from_bytes32(jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decompress_matches_jax():
    b = _point_bytes(np.random.default_rng(23))
    (x, y, _, t), ok = ed.decompress(torch.from_numpy(b))
    (jx, jy, _, jt), jok = jax.jit(jed.decompress)(jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.any() and not ok.all()
    xc, yc, tc = fe.canon(x), fe.canon(y), fe.canon(t)
    for i in np.nonzero(ok.numpy())[0]:
        assert fe.limbs_to_int(xc[i]) == \
            _jdigits_to_int(np.asarray(jfe.canonical(jx[i])))
        assert fe.limbs_to_int(yc[i]) == \
            _jdigits_to_int(np.asarray(jfe.canonical(jy[i])))
        assert fe.limbs_to_int(tc[i]) == \
            _jdigits_to_int(np.asarray(jfe.canonical(jt[i])))


def test_small_order_encodings_match_jax():
    np.testing.assert_array_equal(ed._small_order_encodings(),
                                  jed._small_order_encodings())
    b = _point_bytes(np.random.default_rng(24))
    np.testing.assert_array_equal(
        ed.is_small_order_encoding(torch.from_numpy(b)).numpy(),
        np.asarray(jed.is_small_order_encoding(jnp.asarray(b))))


@pytest.mark.parametrize("entry", ["ed25519", "cuda_ed"])
def test_plain_verify_batch_matches_jax(entry):
    """16 lanes x 64-byte messages, the mixed verdict pattern, through
    the plain verify_batch and through the kernels' glue on CPU tensors
    (each wrapper's plain version)."""
    sig, pub, msg, ln = mixed_batch(16, 64, 13)
    want = np.asarray(jax.jit(jed.verify_batch)(
        jnp.asarray(sig), jnp.asarray(pub), jnp.asarray(msg),
        jnp.asarray(ln)))
    mod = ed if entry == "ed25519" else cuda_ed
    got = mod.verify_batch(sig, pub, msg, ln, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    assert not want[-3:].any()
