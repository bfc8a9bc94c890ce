"""The port's RLC batch verification (plain versions, device="cpu")
against the JAX package's plain reference, ops/ed25519.rlc_verify_batch,
at tests/test_rlc.py's shape (8 lanes x 48-byte messages).

The same numpy inputs go to both packages and every comparison is exact
(booleans and integers). The JAX reference runs eagerly (one call per
case; its Pallas counterpart in interpret mode takes hours, as
tests/test_pallas_msm.py notes). Also here: the scalar ops against the
JAX ones, the plain stage 1 (window sums and the digit sums of z S)
against Python-int arithmetic, the glue's aten operation count, and the
RLC wrapper against the port's strict verify_batch.

The non-decodable-R case pins a reference behaviour: a lane whose R has
y < p but no square root is out of lane_pre and out of every term of
the sum (its z S too), so the batch still passes on its other lanes.
(The JAX package's Pallas glue sums z S over such a lane and fails the
batch; ROADMAP.md section C.)"""
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu.utils import ed25519_ref as jref
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import fe25519 as fe
from firedancer_tpu_torch.ops import cuda_msm, msm
from firedancer_tpu_torch.utils import chaos
from firedancer_tpu_torch.utils import ed25519_ref as ref
from torch_rlc_cases import KEPT_OUT, stage_inputs

B, MLEN = 8, 48


def _batch(seed: int):
    """test_rlc.py's batch: 8 signers from fixed seeds, random messages."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((B, 64), np.uint8)
    pub = np.zeros((B, 32), np.uint8)
    msg = np.zeros((B, MLEN), np.uint8)
    for i in range(B):
        key = hashlib.sha256(b"rlc-%d" % i).digest()
        m = rng.bytes(MLEN)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, m), np.uint8)
        msg[i] = np.frombuffer(m, np.uint8)
    z = rng.integers(0, 256, (B, 16), np.uint8)
    return sig, pub, msg, np.full(B, MLEN, np.int32), z


def _case(name: str):
    """-> (sig, pub, msg, msg_len, z, expected batch verdict)."""
    sig, pub, msg, ln, z = _batch(len(name))
    want = True
    if name == "corrupt_s":
        sig[3, 40] ^= 1
        want = False
    elif name == "masked":
        sig[1, 32:] = np.frombuffer((ed.L + 7).to_bytes(32, "little"),
                                    np.uint8)                 # S >= l
        pub[2] = np.frombuffer((1).to_bytes(32, "little"), np.uint8)
        sig[6, :32] = ed._small_order_encodings()[3]          # small R
    elif name == "undecodable_r":
        sig[4, :32] = chaos.undecodable_point(4)
    elif name.startswith("torsion"):
        pub[0], sig[0] = (np.frombuffer(x, np.uint8) for x in
                          chaos.torsion_sign(b"\x11" * 32, msg[0].tobytes()))
        z[0, 0] &= 0xF8                                       # z_0 = 0 mod 8
        if name == "torsion_z_odd":
            z[0, 0] |= 1
            want = False
    return sig, pub, msg, ln, z, want


@pytest.mark.parametrize("name", ["valid", "corrupt_s", "masked",
                                  "undecodable_r", "torsion_z0_mod8",
                                  "torsion_z_odd"])
def test_rlc_verify_batch_matches_jax(name):
    sig, pub, msg, ln, z, want = _case(name)
    ok, pre = ed.rlc_verify_batch(sig, pub, msg, ln, z, device="cpu")
    jok, jpre = jed.rlc_verify_batch(*(jnp.asarray(x) for x in
                                       (sig, pub, msg, ln, z)))
    assert bool(ok) == bool(jok) == want
    assert pre.tolist() == np.asarray(jpre).tolist()
    bad = {"masked": [1, 2, 6], "undecodable_r": [4]}.get(name, [])
    assert pre.tolist() == [i not in bad for i in range(B)]


def test_scalar_ops_match_jax():
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "little") % ed.L
            for _ in range(12)]
    zs = [int.from_bytes(rng.bytes(16), "little") for _ in range(12)]
    vals[0], zs[0] = ed.L - 1, (1 << 128) - 1                 # extremes
    a = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                  for v in vals])
    z = np.stack([np.frombuffer(v.to_bytes(16, "little"), np.uint8)
                  for v in zs])
    a_d = jnp.asarray(np.stack([jed._int_digits(v, 20) for v in vals]))
    z_d = jnp.asarray(np.stack([jed._int_digits(v, 10) for v in zs]))

    def from_digits(d):
        return sum(int(x) << (jed.BITS * i) for i, x in enumerate(d))

    got = ed.sc_mul_mod_l(torch.from_numpy(a), torch.from_numpy(z))
    want = np.asarray(jed.sc_mul_mod_l(a_d, z_d))
    for i in range(12):
        assert int.from_bytes(bytes(got[i].numpy()), "little") \
            == from_digits(want[i]) == vals[i] * zs[i] % ed.L
    s = ed.sc_sum_mod_l(torch.from_numpy(a))
    assert int.from_bytes(bytes(s.numpy()), "little") \
        == from_digits(np.asarray(jed.sc_sum_mod_l(a_d, axis=0))) \
        == sum(vals) % ed.L
    np.testing.assert_array_equal(ed.sc_windows4(torch.from_numpy(a)),
                                  np.asarray(jed.sc_windows4(a_d)))


def test_plain_stage1_window_sums_match_python_ints():
    """Every window sum of the plain stage 1, in affine coordinates,
    equals sum over the kept lanes of [zk_j](-A) + [z_j](-R) computed
    with Python integers (zk = z (k64 mod l) mod l), and the s that
    stage 2 derives from the digit sums equals sum z S mod l over them."""
    (pub, sig, k64, z), s = stage_inputs(10, 71)
    wsum, lane_ok, sdig = msm.msm_stage1(*(torch.from_numpy(x)
                                           for x in (pub, sig, k64, z)))
    assert lane_ok.tolist() == [int(i not in KEPT_OUT) for i in range(10)]
    kept = np.nonzero(lane_ok.numpy())[0]
    zi = [int.from_bytes(bytes(z[i]), "little") for i in range(10)]
    zk = [zi[i] * (int.from_bytes(bytes(k64[i]), "little") % ed.L) % ed.L
          for i in range(10)]
    want_s = sum(zi[i] * int.from_bytes(bytes(sig[i, 32:]), "little")
                 for i in kept) % ed.L
    got_s = ed.sc_reduce_digits(sdig.sum(0))
    assert int.from_bytes(bytes(got_s.numpy()), "little") == want_s \
        == int.from_bytes(bytes(s), "little")

    def neg(p):
        return (ref.P - p[0], p[1], p[2], ref.P - p[3])

    for j in range(64):
        acc = (0, 1, 1, 0)
        for i in kept:
            a = neg(ref.pt_decompress(bytes(pub[i])))
            r = neg(ref.pt_decompress(bytes(sig[i, :32])))
            acc = ref.pt_add(acc, ref.pt_mul((zk[i] >> (4 * j)) & 15, a))
            if j < 32:
                acc = ref.pt_add(acc, ref.pt_mul((zi[i] >> (4 * j)) & 15, r))
        got = [fe.limbs_to_int(wsum[0, j, c]) % ref.P for c in range(3)]
        zinv = pow(got[2], ref.P - 2, ref.P)
        winv = pow(acc[2], ref.P - 2, ref.P)
        assert (got[0] * zinv % ref.P, got[1] * zinv % ref.P) == \
            (acc[0] * winv % ref.P, acc[1] * winv % ref.P), j


class _CountOps:
    """Counts the aten operations issued under it, by name."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        names = self.names = []

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                names.append(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))
        self._mode = Count()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def test_rlc_glue_issues_few_aten_ops():
    """rlc_verify outside its three kernel callables (stubbed here with
    precomputed results) issues 2 aten operations, the two compares of
    its verdicts: R || A || M is read in place by the SHA-512 kernel (no
    concat), and the prechecks and every scalar mod l run inside the MSM
    stages."""
    sig, pub, msg, ln, z = (torch.from_numpy(x) for x in _batch(3))
    k64 = torch.zeros((B, 64), dtype=torch.uint8)
    pre = torch.ones(B, dtype=torch.int32)
    s1 = msm.msm_stage1(pub, sig, k64, z)
    s2 = (torch.tensor(1, dtype=torch.int32), torch.zeros((4, 10)))
    with _CountOps() as ops:
        ok, pre = ed.rlc_verify(sig, pub, msg, ln, z, lambda *a: (k64, pre),
                                lambda *a: s1, lambda *a: s2)
    assert bool(ok) and pre.tolist() == [True] * B
    assert "aten.cat" not in ops.names, ops.names
    assert 0 < len(ops.names) <= 2, ops.names


def test_strict_glue_issues_few_aten_ops():
    """strict_verify outside its two kernel callables (stubbed here with
    precomputed results) issues at most 4 aten operations (2: the and of
    the prechecks with the core verdicts, and its compare), and no
    concat: the SHA-512 kernel reads R || A || M in place and runs the
    prechecks."""
    sig, pub, msg, ln, _ = (torch.from_numpy(x) for x in _batch(4))
    k64 = torch.zeros((B, 64), dtype=torch.uint8)
    pre = torch.tensor([1, 0, 1, 1, 1, 1, 0, 1], dtype=torch.int32)
    core = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], dtype=torch.int32)
    with _CountOps() as ops:
        ok = ed.strict_verify(sig, pub, msg, ln, lambda *a: (k64, pre),
                              lambda *a: core)
    assert ok.tolist() == [i not in (1, 2, 6) for i in range(B)]
    assert "aten.cat" not in ops.names, ops.names
    assert 0 < len(ops.names) <= 4, ops.names


@pytest.mark.parametrize("corrupt", [(), (0,), (2, 5)])
def test_verify_batch_rlc_matches_strict(corrupt):
    sig, pub, msg, ln, _ = _batch(5)
    for i in corrupt:
        sig[i, 40] ^= 1
    got = ed.verify_batch_rlc(sig, pub, msg, ln,
                              rng=np.random.default_rng(9), device="cpu")
    wrapped = cuda_msm.verify_batch_rlc(sig, pub, msg, ln,
                                        rng=np.random.default_rng(9),
                                        device="cpu")
    want = ed.verify_batch(sig, pub, msg, ln, device="cpu")
    assert got.tolist() == wrapped.tolist() == want.tolist() \
        == [i not in corrupt for i in range(B)]


def test_torsion_forgery_matches_reference_helper():
    """The port's torsion_sign is the reference's, byte for byte."""
    from firedancer_tpu.utils import chaos as jchaos
    m = b"torsion-msg"
    assert chaos.torsion_sign(b"\x22" * 32, m) == \
        jchaos.torsion_sign(b"\x22" * 32, m)
    pub, sig = chaos.torsion_sign(b"\x22" * 32, m)
    assert not jref.verify(sig, pub, m)          # strict always rejects
