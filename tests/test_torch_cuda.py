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

from firedancer_tpu_torch.ops import (blake3, bmtree, cuda_blake3, cuda_ed,
                                      cuda_msm, cuda_sha, cuda_sha256, msm,
                                      poh, reedsol)
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import params, sha2
from firedancer_tpu_torch.utils import ed25519_ref as ref
from firedancer_tpu_torch.utils.chaos import undecodable_point
from torch_rlc_cases import (PRE_CLASSES, ram_inputs, signed,
                             spread_blocks, stage_inputs)
from torch_wave_cases import chain_block, pair_waves, staged_inputs, wave_cases
import torch_hash_cases as hc

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


def _wave_on_card(dev, packed, hi, lo):
    from firedancer_tpu_torch.ops import cuda_wave
    ins = [torch.from_numpy(x) for x in (packed, hi, lo)]
    before = cuda_wave.launches["wave_scan"]
    got = cuda_wave.wave_scan(*(x.to(dev) for x in ins))
    torch.cuda.synchronize()
    assert cuda_wave.launches["wave_scan"] == before + 1
    return [g.cpu() for g in got], cuda_wave.wave_scan_plain(*ins)


def test_wave_scan_kernel_branches_match_plain(dev):
    """Every branch of the kernel's plan against the plain version, each
    with its balances in shared memory and, over 40,000 account slots,
    in device memory: the u64-edge and random cases without bucket
    padding (a last chunk that ends part way, an A off a multiple of 4)
    and a chain of 300 one-lane waves, one warp over a resident table;
    waves of 100 lanes, four warps at a named barrier; waves of 1,500
    lanes, the general loop; a chain of 4,000, the ring with one scanning
    warp beside the producer."""
    from firedancer_tpu_torch.ops import cuda_wave
    cases = {name: staged_inputs(*wave_cases()[name], crop=True)
             for name in ("u64_edges", "random1")}
    cases.update(chain300=staged_inputs(*chain_block(300)),
                 pairs100=staged_inputs(*pair_waves(100, 3)),
                 pairs1500=staged_inputs(*pair_waves(1500, 2), crop=True),
                 chain4000=staged_inputs(*chain_block(4000)))
    branches = set()
    for name, (packed, hi, lo, active) in cases.items():
        for n in (len(hi), 40_000):
            h, l = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
            h[:len(hi)], l[:len(lo)] = hi, lo
            p = cuda_wave.plan(*packed.shape[:2], n)
            branches.add((name, p["ring"], p["sbal"], p["scan_threads"]))
            got, want = _wave_on_card(dev, packed, h, l)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, n)
            assert int((got[2] >= 0).sum()) == active
    assert {(r, s) for _, r, s, _ in branches} == {(0, 0), (0, 1), (1, 0),
                                                   (1, 1)}
    assert {th for *_, th in branches} >= {32, 128, 1024}


def test_wave_scan_phase11_shapes_match_plain(dev):
    """chip_smoke.py phase 11's five shapes (tools/wave_bench.py), each
    on its branch of the plan: bank0's wave and the bank's observed wave
    resident with one warp, the random block through the ring, 32,768
    account slots in device memory, an all-inactive table."""
    from firedancer_tpu_torch.ops import cuda_wave
    from firedancer_tpu_torch.tools import wave_bench
    branch = {}
    for name, _, _, (packed, hi, lo, *_rest) in wave_bench.shapes():
        p = cuda_wave.plan(*packed.shape[:2], len(hi))
        branch[name] = (p["ring"], p["sbal"], p["scan_threads"] == 32)
        got, want = _wave_on_card(dev, packed, hi, lo)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    assert branch == {"wave_scan": (0, 1, True),
                      "wave_scan@bank_observed": (0, 1, True),
                      "wave_scan@random": (1, 1, False),
                      "wave_scan@global_balances": (1, 0, False),
                      "wave_scan@inactive": (0, 1, True)}


def test_wave_scan_refuses_misaligned_views_on_card(dev):
    """A view off a 16-byte boundary raises before any launch; the
    executor's bal[1] of a bucketed A is taken."""
    from firedancer_tpu_torch.ops import cuda_wave
    p = torch.zeros((2, 4, 7), dtype=torch.uint32, device=dev)
    bal = torch.zeros(24, dtype=torch.uint32, device=dev)
    before = cuda_wave.launches["wave_scan"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_wave.wave_scan(p, bal[:8], bal[9:17])
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_wave.wave_scan_slab(
            torch.zeros(57, dtype=torch.uint32, device=dev)[1:].view(2, 4, 7),
            bal[:8], bal[8:16])
    assert cuda_wave.launches["wave_scan"] == before
    two = bal[:16].view(2, 8)
    got = cuda_wave.wave_scan(p, two[0], two[1])
    assert not any(g.cpu().numpy().any() for g in got[:2])
    assert (got[2] == cuda_wave.STATUS_PAD).all()


# -- SHA-256, PoH, bmtree, BLAKE3, lthash, Reed-Solomon --------------------

@pytest.mark.parametrize("width", [1296, 1297])
def test_sha256_kernel_matches_plain(dev, width):
    """Row widths 1296 and 1297: the same staging path, every row at
    another alignment at 1297."""
    lens = list(hc.SHA256_EDGES) + list(
        np.random.default_rng(width).integers(0, width + 1, 500))
    msg, ln = hc.rows(lens, width, width)
    m, l = torch.from_numpy(msg).to(dev), torch.from_numpy(ln).to(dev)
    before = cuda_sha256.launches["sha256"]
    got = cuda_sha256.sha256(m, l)
    assert cuda_sha256.launches["sha256"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), hc.sha256_want(msg, ln))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  sha2.sha256(m, l).cpu().numpy())


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", hc.SHA256_WIDTHS)
def test_sha256_kernel_widths_and_offsets_match_plain(dev, width, offset):
    """The staged windows at the paths' row widths and base offsets 0-3,
    a warp of edges and random lengths and a second warp in part (lanes
    past the batch)."""
    lens = list(hc.SHA256_EDGES) + [width - 1, width] + list(
        np.random.default_rng(width + offset).integers(0, width + 1, 40))
    msg, ln = hc.offset_rows(lens, width, offset, width + offset)
    buf = torch.zeros(msg.size + 16, dtype=torch.uint8, device=dev)
    m = buf[offset:offset + msg.size].view(msg.shape)
    m.copy_(torch.from_numpy(np.ascontiguousarray(msg)))
    assert m.data_ptr() % 16 == offset
    l = torch.from_numpy(ln).to(dev)
    got = cuda_sha256.sha256(m, l).cpu().numpy()
    np.testing.assert_array_equal(got, hc.sha256_want(msg, ln))
    np.testing.assert_array_equal(got, sha2.sha256(m, l).cpu().numpy())


@pytest.mark.parametrize("max_hashes", [16, 64])
def test_poh_verify_kernel_matches_plain(dev, max_hashes):
    args, want = hc.poh_entries(max_hashes, 5, reps=8)
    t = [torch.from_numpy(a).to(dev) for a in args]
    got = cuda_sha256.poh_verify(*t, max_hashes).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, poh.poh_verify_plain(*t, max_hashes).cpu().numpy())
    np.testing.assert_array_equal(
        got, poh.poh_verify_entries(*args, max_hashes).cpu().numpy())


def test_bmtree_root_on_card_matches_host(dev):
    rng = np.random.default_rng(8)
    leaves = rng.integers(0, 256, (9, 64, 32), np.uint8)
    cnt = np.array([1, 2, 3, 17, 32, 33, 63, 64, 5], np.int32)
    lp, np_ = bmtree.LEAF_PREFIX_SHREDS, bmtree.NODE_PREFIX_SHREDS
    got = bmtree.bmtree_root(leaves, cnt, 64, lp, np_).cpu().numpy()
    for t, c in enumerate(cnt):
        assert bytes(got[t]) == bmtree.host_bmtree_root(
            [bytes(x) for x in leaves[t, :c]], lp, np_)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [2048, 1027, hc.BLAKE3_BANK_HASH_LEN])
def test_blake3_and_lthash_kernels_match_plain(dev, width, offset):
    """Both entries at row widths 2048, 1027 and the bank hash's 81 and
    base offsets 0-3 (the staged windows at every alignment), over three
    tiles, the last in part (task tables of every size): every edge, the
    bank hash's 81 bytes and random lengths."""
    lens = list(hc.BLAKE3_EDGES) + [hc.BLAKE3_BANK_HASH_LEN] + list(
        np.random.default_rng(width + offset).integers(0, width + 1, 28))
    msg, ln = hc.offset_rows(lens, width, offset, 3 * width + offset)
    buf = torch.zeros(msg.size + 16, dtype=torch.uint8, device=dev)
    m = buf[offset:offset + msg.size].view(msg.shape)
    m.copy_(torch.from_numpy(np.ascontiguousarray(msg)))
    assert m.data_ptr() % 16 == offset
    l = torch.from_numpy(ln).to(dev)
    for entry, kern, want, plain in (
            ("blake3", cuda_blake3.blake3, hc.blake3_want,
             blake3.blake3_plain),
            ("lthash", cuda_blake3.lthash, hc.lthash_want,
             blake3.lthash_plain)):
        before = cuda_blake3.launches[entry]
        got = kern(m, l)
        assert cuda_blake3.launches[entry] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want(msg, ln))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      plain(m, l).cpu().numpy())


@pytest.mark.parametrize("shape", ["phase15", "bank_hash"])
def test_blake3_kernels_at_smoke_shapes_match_plain(dev, shape):
    """chip_smoke.py phase 15's two shapes: 4096 lanes of 0-2048 bytes and
    4096 lanes of 81 bytes (every row at another alignment), both entries
    == plain on every lane and == blake3_ref on the first 64."""
    from firedancer_tpu_torch.tools import blake3_bench
    msg, ln = dict((n, r) for n, r, _ in blake3_bench.shapes(False))[shape]
    m, l = torch.from_numpy(msg).to(dev), torch.from_numpy(ln).to(dev)
    for kern, want, plain in (
            (cuda_blake3.blake3, hc.blake3_want, blake3.blake3_plain),
            (cuda_blake3.lthash, hc.lthash_want, blake3.lthash_plain)):
        got = kern(m, l)
        assert torch.equal(got, plain(m, l))
        np.testing.assert_array_equal(got[:64].cpu().numpy(),
                                      want(msg[:64], ln[:64]))


def test_reedsol_on_card_matches_cpu(dev):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (8, 32, 1019), np.uint8)
    par = reedsol.encode(data, 32)
    assert par.device.type == "cuda"
    np.testing.assert_array_equal(
        par.cpu().numpy(), reedsol.encode(data, 32, device="cpu").numpy())
    present = tuple(range(16, 48))
    code = np.concatenate([data, par.cpu().numpy()], axis=1)
    got = reedsol.recover(code[:, list(present)], present, 32, 32)
    np.testing.assert_array_equal(got.cpu().numpy(), data)


def test_hash_wrappers_refuse_bad_tensors(dev):
    m = torch.zeros((4, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="msg_len"):
        cuda_sha256.sha256(m, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="msg"):
        cuda_blake3.lthash(m[:, ::2], torch.zeros(4, dtype=torch.int32,
                                                  device=dev))
    z = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
    n = torch.ones(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="has_mixin"):
        cuda_sha256.poh_verify(z, n, z, n, z, 4)


def _follower_slices(n_slots=5, hashes_per_tick=16):
    """Slots of poh entries (a txn group mixed into the odd slots, two
    ticks each) shredded by the port's leader core and recovered into
    slice frames by its recover core."""
    import struct

    from firedancer_tpu_torch.shred.shred_dest import ClusterNode
    from firedancer_tpu_torch.tiles import shred as tshred
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    seed = bytes(range(32))
    pub = ref.keypair(seed)[-1]
    sent = []

    class Sock:
        def sendto(self, wire, addr):
            sent.append(bytes(wire))

    class Capture:
        def __init__(self):
            self.frames = []

        def publish(self, frame, sig=0):
            self.frames.append(bytes(frame))
    leader = tshred.ShredLeaderCore(
        lambda r: ref.sign(seed, r), pub,
        [ClusterNode(b"\x55" * 32, 100, ("127.0.0.1", 9))], Sock())
    txns = make_signed_txns(4 * n_slots, seed=3)
    state = bytes(32)
    for slot in range(n_slots):
        hashes = 0
        if slot % 2:
            group = txns[4 * slot:4 * slot + 4]
            mixin = hashlib.sha256(b"".join(t[1:65] for t in group)).digest()
            prev, state = state, poh.host_poh_mixin(state, mixin)
            hashes = 1
            blob = b"".join(struct.pack("<H", len(t)) + t for t in group)
            leader.on_entry(struct.pack("<QIIB", slot, 0, 1, 1) + prev
                            + state + mixin + b"\0"
                            + struct.pack("<H", len(group)) + blob)
        for tick in range(2):
            prev = state
            state = poh.host_poh_append(state, hashes_per_tick - hashes)
            leader.on_entry(struct.pack("<QIIB", slot, tick,
                                        hashes_per_tick - hashes, 0)
                            + prev + state + bytes(32)
                            + bytes([tick == 1]) + struct.pack("<H", 0))
            hashes = 0
    out = Capture()
    rec = tshred.ShredRecoverCore(pub, out, None)
    for w in sent:
        rec.on_shred(w)
    return out.frames


def test_replay_on_card_matches_cpu(dev):
    """The follower's replay with its PoH check (poh_verify) and bank hash
    (lthash) on the card equals the plain versions' on the CPU, slot by
    slot; both kernels launched."""
    from firedancer_tpu_torch.tiles.replay import ReplayCore
    from firedancer_tpu_torch.tiles.synth import synth_signer_seed
    frames = _follower_slices()
    genesis = {ref.keypair(synth_signer_seed(i))[-1]: 1 << 44
               for i in range(16)}
    n0 = (cuda_sha256.launches["poh_verify"], cuda_blake3.launches["lthash"])
    cores = [ReplayCore(genesis=genesis, hashes_per_tick=16, device=d)
             for d in ("cuda", "cpu")]
    for f in frames:
        for c in cores:
            c.on_slice(f)
    assert cores[0].bank_hash_of == cores[1].bank_hash_of
    assert cores[0].hash_of == cores[1].hash_of
    assert cores[0].metrics == cores[1].metrics
    assert cores[0].metrics["poh_fail"] == 0
    assert cores[0].metrics["exec_ok"] == 8
    assert cuda_sha256.launches["poh_verify"] > n0[0]
    assert cuda_blake3.launches["lthash"] > n0[1]


def test_exec_tiles_on_card_match_plain(dev):
    """The exec tile family with its shards on the card (each frame one
    launch of the wave-scan kernel) against the same drills on the plain
    wave scan: the fan-out's poh frames, done frags and balances, the
    shard death drill's, and the replay fan-out's bank hashes
    (tools/exec_drills.py, chip_smoke.py phase 20a)."""
    import os
    from firedancer_tpu_torch.ops import cuda_wave
    from firedancer_tpu_torch.runtime import Workspace
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.tools import exec_drills
    txns = make_signed_txns(24, seed=77)
    got = {}
    for d in ("cuda", "cpu"):
        w = Workspace(f"/fdtt_cx{os.getpid()}", 1 << 26)
        try:
            n0 = cuda_wave.launches["wave_scan"]
            bi = exec_drills.byte_identity(w, txns[:18], device=d)
            sd = exec_drills.shard_death(w, txns[:12], device=d)
            rf = exec_drills.replay_fanout(w, txns, 4, device=d)
            got[d] = (bi["poh"], bi["done"], bi["balances"], sd["poh"],
                      sd["balances"], rf["bank_hashes"])
            if d == "cuda":
                assert cuda_wave.launches["wave_scan"] > n0
                assert rf["launches"] >= sum(rf["shard_frames"]) > 0
        finally:
            w.close()
            w.unlink()
    assert got["cuda"] == got["cpu"]


def test_gossvf_on_card_matches_plain(dev):
    """gossvf's packets (1-33 CRDS values of every class) on the card, in
    both modes, against the plain versions with generators of one
    seed (tools/gossvf_bench.py, chip_smoke.py phase 19a)."""
    from firedancer_tpu_torch.tools import gossvf_bench
    got = gossvf_bench.check(str(dev))
    assert set(got) == set(gossvf_bench.PACKETS)


def test_device_capture_names_the_strict_kernels(dev, tmp_path):
    """A prof/device.py DeviceCapture window around the strict path on the
    card: torch.profiler records the kernels of the ctypes-loaded
    libraries (each with its own static cudart), so the manifest names
    sha512_kernel and ed25519_verify_kernel with their launches, the
    kernel events lie inside the recorded window on the monotonic clock,
    and the busy share is a fraction."""
    import json
    import os
    from firedancer_tpu_torch.prof import ProfRegion
    from firedancer_tpu_torch.prof import device as pdev
    from firedancer_tpu_torch.runtime import Workspace
    from firedancer_tpu_torch.utils.tempo import monotonic_ns
    w = Workspace(f"/fdtt_tcap{os.getpid()}", 1 << 20)
    plan = {"topology": f"tcap{os.getpid()}", "prof": {"capture_ms": 30.0}}
    path = pdev.capture_manifest_path(plan["topology"], "verify")
    try:
        region = ProfRegion.create(w, 64, 64)
        cap = pdev.DeviceCapture(plan, "verify", region, device="cuda",
                                 warm=True)
        batch = _signed(256, 128, 9)
        cuda_ed.verify_batch(*batch)
        region.request_capture()
        cap.poll()
        launches = 0
        while cap.poll() is None:
            cuda_ed.verify_batch(*batch)
            launches += 1
        doc = json.load(open(path))
        assert doc["ok"], doc["error"]
        names = {n.removeprefix("void ").split("<")[0].split("(")[0]:
                 k["launches"] for n, k in doc["kernels"].items()}
        assert names["sha512_kernel"] >= launches
        assert names["ed25519_verify_kernel"] >= launches
        assert 0 < doc["device_busy_share"] <= 1
        assert doc["clock"] == "mark" and doc["kernel_events"]
        t0 = doc["t1_ns"] - int(doc["recorded_ms"] * 1e6)
        for _, ts, dur in doc["kernel_events"]:
            assert t0 - 10**6 <= ts <= doc["t1_ns"] <= monotonic_ns()
    finally:
        w.close()
        Workspace.unlink_name(w.name)
        if os.path.exists(path):
            os.unlink(path)
