"""The plain version of the fused verify kernel (ops/ed25519.py
`verify_core`, mirrored limb for limb by csrc/ed25519_verify.cu) against
the JAX kernel body pallas_ed._verify_core, run as pure jnp on the CPU
exactly as tests/test_pallas_ed.py runs it (the Mosaic roll swapped for
jnp.roll). Also: the fixed-base table carried across from the JAX
package equals the port's own. Exact: verdicts are integers."""
import hashlib

import jax.numpy as jnp
import numpy as np
import torch

from firedancer_tpu.ops import pallas_ed as ped
from firedancer_tpu_torch.ops import cuda_ed, params
from firedancer_tpu_torch.ops import ed25519 as ed
from test_torch_ed25519 import mixed_batch


def test_fixed_base_tables_from_jax_equal_own():
    got = params.from_jax_tables(*ped._fb_tables())
    own = params.own_tables()
    assert got.shape == own.shape == (64, 16, 3, 10)
    assert got.dtype == own.dtype == np.int32
    np.testing.assert_array_equal(got, own)


def test_verify_core_matches_jax_kernel_body(monkeypatch):
    """16 lanes: valid, corrupted R/S/msg/A, small-order A and R, S >= l
    (the core's verdict, without the glue's masks, on every lane)."""
    sig, pub, msg, _ = mixed_batch(16, 64, 31)
    k64 = np.stack([np.frombuffer(hashlib.sha512(
        bytes(sig[i, :32]) + bytes(pub[i]) + bytes(msg[i])).digest(),
        np.uint8) for i in range(len(sig))])
    monkeypatch.setattr(ped, "_ROLL",
                        lambda x, shift, axis: jnp.roll(x, shift, axis))
    ymx, ypx, t2d = ped._fb_tables()
    rows = lambda a: jnp.asarray(a.T.astype(np.int32))  # noqa: E731
    want = np.asarray(ped._verify_core(
        rows(pub), rows(sig[:, :32]), rows(k64), rows(sig[:, 32:]),
        jnp.asarray(ymx), jnp.asarray(ypx), jnp.asarray(t2d)))[0]
    s, p, k = (torch.from_numpy(x) for x in (sig, pub, k64))
    got = ed.verify_core(s, p, k, params.fixed_base_tables("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    # the wrapper on CPU tensors is the same plain version, no launch
    before = cuda_ed.launches
    np.testing.assert_array_equal(cuda_ed.verify_core(s, p, k).numpy(), want)
    assert cuda_ed.launches == before
