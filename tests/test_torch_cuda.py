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

from firedancer_tpu_torch.ops import cuda_ed, cuda_msm, cuda_sha, msm
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import params, sha2
from firedancer_tpu_torch.utils import ed25519_ref as ref
from firedancer_tpu_torch.utils.chaos import undecodable_point
from torch_rlc_cases import (PRE_CLASSES, ram_inputs, signed,
                             spread_blocks, stage_inputs)
from torch_wave_cases import wave_cases

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
    before = dict(cuda_sha.launches)
    got = cuda_sha.sha512(m, ln)
    assert cuda_sha.launches == dict(before, sha512=before["sha512"] + 1)
    plain = sha2.sha512(m, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    for i in (0, 3, 8, len(lens) - 1):
        assert bytes(got[i].cpu().numpy()) == \
            hashlib.sha512(bytes(msg[i, :lens[i]])).digest()


@pytest.mark.parametrize("width", [1232, 1229])
def test_sha512_ram_kernel_matches_plain(dev, width):
    """The in-place entry on 300 lanes (ten warps, the last ragged): every
    precheck class, lengths at the padding edges and random ones, and
    both copy paths (staged 16-byte pieces at width 1232, each thread's
    own reads at 1229): k64 and pre equal the plain version's and
    hashlib's."""
    sig, pub, msg, _ = ram_inputs(width, width, 60)
    rng = np.random.default_rng(61)
    idx = np.arange(300) % len(PRE_CLASSES)
    sig, pub = sig[idx].copy(), pub[idx].copy()
    msg = rng.integers(0, 256, (300, width), np.uint8)
    lens = rng.integers(0, width + 1, 300).astype(np.int32)
    lens[:8] = [0, 47, 48, 111, 112, 175, 176, width]
    ins = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, lens)]
    before = dict(cuda_sha.launches)
    k64, pre = cuda_sha.sha512_ram(*ins)
    assert cuda_sha.launches == {k: v + 1 for k, v in before.items()}
    want_k, want_pre = sha2.sha512_ram(*ins)
    torch.cuda.synchronize()
    assert torch.equal(k64, want_k) and torch.equal(pre, want_pre)
    assert pre.cpu().tolist() == [PRE_CLASSES[i][1] for i in idx]
    for i in (0, 5, 7, 299):
        assert bytes(k64[i].cpu().numpy()) == hashlib.sha512(
            bytes(sig[i, :32]) + bytes(pub[i])
            + bytes(msg[i, :lens[i]])).digest()


def test_verify_kernel_matches_plain(dev):
    """45 signatures: the last warp holds three groups past the batch
    edge, which repeat the last signature and write nothing."""
    sig, pub, msg, ln = _signed(45, 100, 52)
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
    ln = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_sha.sha512_ram(m, m[:, :32], m, ln.long())
    with pytest.raises(ValueError):
        cuda_sha.sha512_ram(m, m[:, :31], m, ln)
    with pytest.raises(ValueError):
        cuda_sha.sha512_ram(m, m[:, :32], m.t(), ln)


def test_msm_stage1_kernel_matches_plain(dev):
    """200 lanes (four blocks, the last ragged) with every lane class of
    stage_inputs: every limb of every window sum, lane_ok and the digit
    sums of z S."""
    ins, _ = stage_inputs(200, 54)
    ins = [torch.from_numpy(x).to(dev) for x in ins]
    before = cuda_msm.launches["msm_stage1"]
    got = cuda_msm.msm_stage1(*ins)
    assert cuda_msm.launches["msm_stage1"] == before + 1
    want = msm.msm_stage1(*ins)
    torch.cuda.synchronize()
    assert got[0].shape == (4, 64, 4, 10) and got[2].shape == (4, 13)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("nblk", [1, 2, 5, 32, 79, 128])
def test_msm_stage2_kernel_matches_plain(dev, nblk):
    """The stage-1 sums of 70 lanes as their two blocks or spread over
    nblk (chunks of 1, 2, 3, 6, 9 and 12 blocks, the last chunk ragged at
    5, 32 and 79), with the batch's digit sums (it verifies) and with one
    digit raised by 1 (it does not): verdict and canonical limbs."""
    ins, _ = stage_inputs(70, 55)
    wsum, _, sdig = msm.msm_stage1(*(torch.from_numpy(x).to(dev)
                                     for x in ins))
    if nblk != 2:
        wsum, sdig = spread_blocks(wsum, sdig, nblk)
    tab = params.fixed_base_tables(dev)
    bad = sdig.clone()
    bad[0, 5] += 1
    for d, verdict in ((sdig, 1), (bad, 0)):
        before = cuda_msm.launches["msm_stage2"]
        ok, point = cuda_msm.msm_stage2(wsum, d)
        assert cuda_msm.launches["msm_stage2"] == before + 1
        want_ok, want_pt = msm.msm_stage2(wsum, d, tab)
        torch.cuda.synchronize()
        assert int(ok) == int(want_ok) == verdict
        assert torch.equal(point, want_pt)


def test_rlc_verify_batch_on_card_matches_cpu(dev):
    """A failing batch (corrupt R, message and small-order A lanes) and a
    passing one with a non-decodable R lane: the kernels' verdicts equal
    the plain versions'."""
    bad = _signed(40, 64, 56)
    good = signed(24, 64, 57)
    good[0][5, :32] = undecodable_point(58)
    z = np.random.default_rng(59).integers(0, 256, (40, 16), np.uint8)
    for (sig, pub, msg, ln), verdict in ((bad, False), (good, True)):
        zz = z[:len(sig)]
        ok, pre = cuda_msm.rlc_verify_batch(sig, pub, msg, ln, zz,
                                            device="cuda")
        want_ok, want_pre = cuda_msm.rlc_verify_batch(sig, pub, msg, ln, zz,
                                                      device="cpu")
        assert pre.device.type == "cuda"
        assert bool(ok) == bool(want_ok) == verdict
        assert torch.equal(pre.cpu(), want_pre)
    assert want_pre.tolist() == [i != 5 for i in range(24)]


def test_msm_wrappers_refuse_bad_tensors(dev):
    u8 = dict(dtype=torch.uint8, device=dev)
    pub, sig = torch.zeros((4, 32), **u8), torch.zeros((4, 64), **u8)
    z = torch.zeros((4, 16), **u8)
    with pytest.raises(ValueError):
        cuda_msm.msm_stage1(pub, sig, sig.int(), z)
    with pytest.raises(ValueError):
        cuda_msm.msm_stage1(pub, sig[:, :32], sig, z)
    with pytest.raises(ValueError):
        cuda_msm.msm_stage2(torch.zeros((1, 64, 4, 10), dtype=torch.int32,
                                        device=dev).transpose(0, 1),
                            torch.zeros((64, 13), dtype=torch.int64,
                                        device=dev))
    with pytest.raises(ValueError):
        cuda_msm.msm_stage2(torch.zeros((1, 64, 4, 10), dtype=torch.int32,
                                        device=dev),
                            torch.zeros((1, 13), dtype=torch.int32,
                                        device=dev))


def test_wave_scan_kernel_matches_plain(dev):
    """The wave-scan kernel against its plain version on every case of
    tests/torch_wave_cases.py, with the balances in shared memory and,
    for a table of 40,000 account slots, in the global scratch; then the
    pipelined WaveExecutor on the card against the serial oracle."""
    from firedancer_tpu_torch.funk import Funk
    from firedancer_tpu_torch.ops import cuda_wave
    from firedancer_tpu_torch.svm import executor as texec
    for name, (bal, txns) in wave_cases().items():
        if not txns:
            continue
        key_idx = {}
        for t in txns:
            for k in (t.src, t.dst):
                key_idx.setdefault(k, len(key_idx))
        packed, _, _ = texec.pack_table(txns, key_idx)
        for n in (texec._bucket(len(key_idx) + 1), 40_000):
            hi, lo = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
            for k, i in key_idx.items():
                hi[i], lo[i] = bal.get(k, 0) >> 32, bal.get(k, 0) & 0xFFFFFFFF
            ins = [torch.from_numpy(x) for x in (packed, hi, lo)]
            before = cuda_wave.launches["wave_scan"]
            got = cuda_wave.wave_scan(*(x.to(dev) for x in ins))
            torch.cuda.synchronize()
            assert cuda_wave.launches["wave_scan"] == before + 1
            want = cuda_wave.wave_scan_plain(*ins)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), name
    bal, txns = wave_cases()["random1"]
    oracle = dict(bal)
    want = texec.execute_block_serial(oracle, txns)
    funk = Funk()
    for k, v in bal.items():
        funk.rec_write(None, k, v)
    wx = texec.WaveExecutor("cuda")
    staged = [wx.stage(txns[i:i + 40]) for i in range(0, len(txns), 40)]
    pending, got = None, []
    for wi, st in enumerate(staged):
        if pending is not None:
            got += wx.finalize(funk, pending)
            funk.txn_publish(pending.xid)
        pending = wx.dispatch(funk, None, wi, st)
    got += wx.finalize(funk, pending)
    funk.txn_publish(pending.xid)
    assert got == want
    assert all(funk.rec_query(None, k) == v for k, v in oracle.items())
