"""The kernels' C++ sources compiled for the host and held against their
plain PyTorch versions lane by lane.

csrc/sha512.cu, csrc/ed25519_verify.cu, csrc/ed25519_msm.cu,
csrc/wave_scan.cu, csrc/sha256.cu and csrc/blake3.cu compile as plain C++
when nvcc is absent (__CUDACC__ unset): each kernel's
per-lane part becomes a host function, and the threads that work
together on the card (the four threads of a group that carries one
signature, the threads of MSM stage 2) run one after another. That
checks the sources' arithmetic (padding, big-endian loads of R || A || M
from three rows, limb carries, prechecks, scalar reduction,
decompression, tables, window walk, chunked sums over blocks, Horner,
canonical compare; the wave scan's u64 lane step; SHA-256's big-endian
words and padding, PoH's fixed one-block hashes and clipping, BLAKE3's
little-endian words, flags, counters and root, lthash's lane order) here,
where there is no card; launch, the group's
shuffles, the shared-memory staging and sums, memory and timing are
checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Exact: digests, verdicts and limbs are integers."""
import ctypes as ct
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import fe25519 as fe
from firedancer_tpu_torch.ops import blake3, msm, params, poh, sha2
from firedancer_tpu_torch.ops._build import CSRC
from firedancer_tpu_torch.utils import ed25519_ref as ref
from torch_rlc_cases import (KEPT_OUT, PRE_CLASSES, ram_inputs,
                             spread_blocks, stage_inputs)
from torch_wave_cases import staged_inputs, wave_cases
import torch_hash_cases as hc

VP = ct.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc_host")

    def build(name):
        so = str(out / f"{name}.so")
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared",
                        "-fPIC", "-Wno-unknown-pragmas", "-o", so,
                        os.path.join(CSRC, f"{name}.cu")], check=True)
        return ct.CDLL(so)
    return build


def _sha_host(host_lib):
    fn = host_lib("sha512").sha512_lane_host
    fn.argtypes = [VP, VP, VP, ct.c_int64, VP, VP, VP, ct.c_int, ct.c_int]
    return fn


def test_sha512_source_matches_plain_and_hashlib(host_lib):
    """The generic entry (no R || A prefix), lane by lane, at an aligned
    row width and at one that is not a multiple of 8."""
    fn = _sha_host(host_lib)
    rng = np.random.default_rng(41)
    for width in (1296, 1229):
        lens = np.array([0, 1, 111, 112, 127, 128, 239, 240, width]
                        + list(rng.integers(0, width + 1, 15)), np.int32)
        msg = rng.integers(0, 256, (len(lens), width), np.uint8)
        msg[np.arange(width)[None, :] >= lens[:, None]] = 0
        plain = sha2.sha512(torch.from_numpy(msg), torch.from_numpy(lens))
        out = np.zeros((len(lens), 64), np.uint8)
        for lane in range(len(lens)):
            fn(None, None, msg.ctypes.data, width, lens.ctypes.data,
               out.ctypes.data, None, 0, lane)
        np.testing.assert_array_equal(out, plain.numpy())
        for i, n in enumerate(lens):
            assert bytes(out[i]) == hashlib.sha512(bytes(msg[i, :n])).digest()


@pytest.mark.parametrize("width", [1232, 1237])
@pytest.mark.parametrize("msg_len", [0, 47, 48, 175, 176, 1232])
def test_sha512_ram_source_matches_plain_and_hashlib(host_lib, msg_len,
                                                     width):
    """The in-place entry, lane by lane: k = SHA-512(R || A || M) from
    the three rows (48 and 176 are the first message lengths whose
    padding spills into one more block; 1237 is a row width that is not
    a multiple of 8) and the prechecks, one lane per precheck class,
    against hashlib and sha2.sha512_ram."""
    fn = _sha_host(host_lib)
    sig, pub, msg, lens = ram_inputs(msg_len, width, 43 + msg_len)
    k64 = np.zeros((len(sig), 64), np.uint8)
    pre = np.zeros(len(sig), np.int32)
    for lane in range(len(sig)):
        fn(sig.ctypes.data, pub.ctypes.data, msg.ctypes.data, width,
           lens.ctypes.data, k64.ctypes.data, pre.ctypes.data, 64, lane)
    want_k, want_pre = sha2.sha512_ram(
        *(torch.from_numpy(x) for x in (sig, pub, msg, lens)))
    np.testing.assert_array_equal(k64, want_k.numpy())
    np.testing.assert_array_equal(pre, want_pre.numpy())
    assert pre.tolist() == [ok for _, ok in PRE_CLASSES]
    for i in range(len(sig)):
        assert bytes(k64[i]) == hashlib.sha512(
            bytes(sig[i, :32]) + bytes(pub[i])
            + bytes(msg[i, :msg_len])).digest()


def test_verify_source_matches_plain(host_lib):
    lib = host_lib("ed25519_verify")
    fn = lib.ed25519_verify_kernel
    fn.argtypes = [VP] * 5 + [ct.c_int, ct.c_int]
    rng = np.random.default_rng(42)
    n = 16
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    k64 = np.zeros((n, 64), np.uint8)
    for i in range(n):
        key, m = rng.bytes(32), rng.bytes(40)
        pk, s = ref.keypair(key)[2], ref.sign(key, m)
        if i % 4 == 1:
            s = bytes([s[0] ^ 1]) + s[1:]                # corrupt R
        elif i % 4 == 2:
            m = m[:-1] + bytes([m[-1] ^ 1])              # corrupt msg
        elif i % 8 == 3:
            pk = bytes([pk[0] ^ 1]) + pk[1:]             # corrupt A
        sig[i] = np.frombuffer(s, np.uint8)
        pub[i] = np.frombuffer(pk, np.uint8)
        k64[i] = np.frombuffer(hashlib.sha512(s[:32] + pk + m).digest(),
                               np.uint8)
    pub[n - 1] = ed._small_order_encodings()[1]
    k64[n - 2] = 0xFF                                    # k64 near 2^512
    fb = np.ascontiguousarray(params.own_tables())
    got = np.zeros(n, np.int32)
    for lane in range(n):
        fn(sig.ctypes.data, pub.ctypes.data, k64.ctypes.data, fb.ctypes.data,
           got.ctypes.data, n, lane)
    want = ed.verify_core(*(torch.from_numpy(x) for x in (sig, pub, k64)),
                          params.fixed_base_tables("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _extreme_lanes(pub, sig, k64):
    """Lanes 7-11 of a stage_inputs batch of 12 made scalar and
    encoding extremes: S = l - 1, k64 = 2^512 - 1, a small-order R, and
    A.y and R.y equal to p + 1 (non-canonical)."""
    p1 = np.frombuffer((fe.P + 1).to_bytes(32, "little"), np.uint8)
    sig[7, 32:] = np.frombuffer((ed.L - 1).to_bytes(32, "little"), np.uint8)
    k64[8] = 0xFF
    sig[9, :32] = ed._small_order_encodings()[3]
    pub[10] = p1
    sig[11, :32] = p1


def test_msm_lane_source_matches_plain(host_lib):
    """Stage 1's per-lane part, its group's four threads in turn: the
    prechecks and decompression flags, k, z k and z S mod l, and the 64
    window contributions, limb for limb, over every lane class of
    stage_inputs and the extremes of _extreme_lanes (z = 2^128 - 1 is
    lane 6)."""
    fn = host_lib("ed25519_msm").msm_lane_host
    fn.argtypes = [VP] * 4 + [ct.c_int, VP, VP, VP]
    (pub, sig, k64, z), _ = stage_inputs(12, 61)
    _extreme_lanes(pub, sig, k64)
    want = msm.lane_part(*(torch.from_numpy(x) for x in (pub, sig, k64, z)))
    for lane in range(len(pub)):
        flags = np.zeros(4, np.int32)
        scal = np.zeros((3, 32), np.uint8)
        contrib = np.zeros((64, 4, 10), np.int32)
        fn(pub.ctypes.data, sig.ctypes.data, k64.ctypes.data, z.ctypes.data,
           lane, flags.ctypes.data, scal.ctypes.data, contrib.ctypes.data)
        assert flags.tolist() == [int(want[k][lane]) for k in
                                  ("pre", "a_ok", "r_ok", "ok")], lane
        for i, k in enumerate(("k", "zk", "zs")):
            np.testing.assert_array_equal(scal[i], want[k][lane].numpy())
        np.testing.assert_array_equal(contrib, want["contrib"][lane].numpy())
    assert want["ok"].tolist() == [i not in KEPT_OUT + (9, 10, 11)
                                   for i in range(len(pub))]
    assert want["pre"].tolist() == [i not in (3, 5, 9, 10, 11)
                                    for i in range(len(pub))]
    for lane, (zi, si) in ((6, ((1 << 128) - 1, None)), (7, (None, ed.L - 1))):
        zi = zi or int.from_bytes(bytes(z[lane]), "little")
        si = si or int.from_bytes(bytes(sig[lane, 32:]), "little")
        assert int.from_bytes(bytes(want["zs"][lane].numpy()), "little") \
            == zi * si % ed.L


def test_small_order_table_matches_plain(host_lib):
    """The kernels' __constant__ small-order encodings are the plain
    version's, in its order."""
    fn = host_lib("ed25519_msm").small_order_host
    fn.argtypes, fn.restype = [VP], ct.c_int
    out = np.zeros((32, 32), np.uint8)
    n = fn(out.ctypes.data)
    np.testing.assert_array_equal(out[:n], ed._small_order_encodings())


@pytest.fixture(scope="module")
def stage1_two_blocks():
    """The plain stage 1 of 70 lanes of stage_inputs (two blocks, the
    second ragged) -> (wsum, sdig)."""
    ins, s = stage_inputs(70, 62)
    wsum, _, sdig = msm.msm_stage1(*(torch.from_numpy(x) for x in ins))
    assert wsum.shape == (2, 64, 4, 10) and sdig.shape == (2, 13)
    assert bytes(ed.sc_reduce_digits(sdig.sum(0)).numpy()) == bytes(s)
    return wsum, sdig


@pytest.mark.parametrize("nblk", [1, 2, 5, 32])
def test_msm_stage2_source_matches_plain(host_lib, stage1_two_blocks, nblk):
    """Stage 2 (the sums over blocks in chunks of msm.chunk_len(nblk)
    blocks, then the chunk sums; s from the digit sums; the Horner on a
    group; fixed-base sum; identity test) over the plain stage 1 of 70
    lanes, as its two blocks or spread over nblk: the verdict and the
    canonical limbs of the sum, for the batch's digit sums (it verifies)
    and with one digit raised by 1 (it does not)."""
    fn = host_lib("ed25519_msm").msm_stage2_host
    fn.argtypes = [VP, ct.c_int, VP, VP, VP]
    wsum, sdig = stage1_two_blocks
    if nblk != 2:
        wsum, sdig = spread_blocks(wsum, sdig, nblk)
    w = np.ascontiguousarray(wsum.numpy())
    fb = np.ascontiguousarray(params.own_tables())
    bad = sdig.clone()
    bad[nblk - 1, 3] += 1
    for d, verdict in ((sdig, 1), (bad, 0)):
        dn = np.ascontiguousarray(d.numpy())
        out = np.zeros(41, np.int32)
        fn(w.ctypes.data, nblk, dn.ctypes.data, fb.ctypes.data,
           out.ctypes.data)
        ok, point = msm.msm_stage2(wsum, d, params.fixed_base_tables("cpu"))
        assert out[0] == int(ok) == verdict
        np.testing.assert_array_equal(out[1:].reshape(4, 10), point.numpy())


WAVE_CASES = wave_cases()


@pytest.fixture(scope="module")
def wave_lib(host_lib):
    lib = host_lib("wave_scan")
    lib.wave_scan_host.argtypes = [VP, ct.c_int, ct.c_int, VP, VP, ct.c_int,
                                   VP, VP, VP, ct.c_int, ct.c_int]
    return lib


def _wave_inputs(case, crop=False):
    return staged_inputs(*WAVE_CASES[case], crop=crop)


def _host_scan(wave_lib, packed, hi, lo, chunk_lanes, slots):
    w, c = packed.shape[:2]
    n = len(hi)
    out_hi, out_lo = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    status = np.full((w, c), 7, np.int32)
    rc = wave_lib.wave_scan_host(
        packed.ctypes.data, w, c, hi.ctypes.data, lo.ctypes.data, n,
        out_hi.ctypes.data, out_lo.ctypes.data, status.ctypes.data,
        chunk_lanes.bit_length() - 1, slots)
    assert rc == 0, "a barrier's parity disagrees with ring_parity"
    return out_hi, out_lo, status


def _assert_plain(got, packed, hi, lo):
    from firedancer_tpu_torch.ops import cuda_wave
    want = cuda_wave.wave_scan(*(torch.from_numpy(x)
                                 for x in (packed, hi, lo)))
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g, v.numpy())


@pytest.mark.parametrize("case", [c for c in WAVE_CASES if c != "empty"])
def test_wave_scan_source_matches_plain(wave_lib, case):
    """The wave scan's host build (csrc/wave_scan.cu: the whole scan,
    wave after wave and lane after lane, through the chunks and slots of
    the kernel's own plan) against ops/cuda_wave.py's plain version, on
    the staged table of every case of tests/torch_wave_cases.py (u64
    wraps, hi-word borrows, a self-transfer, fee-only failures, blocks
    across the bucket edges): every balance and status equal."""
    from firedancer_tpu_torch.ops import cuda_wave
    packed, hi, lo, active = _wave_inputs(case)
    w, c = packed.shape[:2]
    plan = cuda_wave.plan(w, c, len(hi), lib=wave_lib)
    got = _host_scan(wave_lib, packed, hi, lo, plan["chunk_lanes"],
                     plan["slots"])
    _assert_plain(got, packed, hi, lo)
    assert (got[2] >= 0).sum() == active == len(WAVE_CASES[case][1])


@pytest.fixture(scope="module")
def phase11_shapes():
    from firedancer_tpu_torch.tools import wave_bench
    return {name: tables for name, _, _, tables in wave_bench.shapes()}


@pytest.mark.parametrize("shape", ["wave_scan", "wave_scan@bank_observed",
                                   "wave_scan@random",
                                   "wave_scan@global_balances",
                                   "wave_scan@inactive"])
def test_wave_scan_source_at_phase11_shapes(wave_lib, phase11_shapes,
                                            shape):
    """chip_smoke.py phase 11's shapes (tools/wave_bench.py) through the
    host build with the chunks and slots of the kernel's plan for each
    (the random block and the 8 x 8192 block through rings of fewer
    slots than chunks, the latter's balances in device memory on the
    card); every balance and status equals the plain version's."""
    from firedancer_tpu_torch.ops import cuda_wave
    packed, hi, lo, _, _, active = phase11_shapes[shape]
    plan = cuda_wave.plan(*packed.shape[:2], len(hi), lib=wave_lib)
    assert plan["ring"] == (shape in ("wave_scan@random",
                                      "wave_scan@global_balances"))
    got = _host_scan(wave_lib, packed, hi, lo, plan["chunk_lanes"],
                     plan["slots"])
    _assert_plain(got, packed, hi, lo)
    assert (got[2] >= 0).sum() == active


RING_GEOMETRY = [(4, 1), (4, 3), (8, 2), (32, 2)]   # (chunk lanes, slots)


@pytest.mark.parametrize("chunk_lanes, slots", RING_GEOMETRY)
@pytest.mark.parametrize("case", ["random1", "random2", "u64_edges",
                                  "self_transfer", "block17"])
def test_wave_scan_ring_source_matches_plain(wave_lib, case, chunk_lanes,
                                             slots):
    """The ring's chunk, slot and parity arithmetic, as the kernel's
    producer and scanning warps use it, through the host build: a table
    of more chunks than slots (one slot too), with a last chunk that ends
    part way (the table without its bucket padding: bulk part and tail
    words) and an A that is not a multiple of 4; every slot reuse flips
    its barriers' parity (the host build returns 1 otherwise), and every
    balance and status equals the plain version's."""
    packed, hi, lo, active = _wave_inputs(case, crop=True)
    got = _host_scan(wave_lib, packed, hi, lo, chunk_lanes, slots)
    _assert_plain(got, packed, hi, lo)
    assert (got[2] >= 0).sum() == active


def test_wave_ring_cases_cover_the_ring():
    """The ring cases above hold what they are named for: more chunks
    than slots at every geometry, a last chunk that ends part way, a
    chunk whose bytes end off a 16-byte boundary, and an A off a multiple
    of 4."""
    tables = [_wave_inputs(c, crop=True) for c in
              ("random1", "random2", "u64_edges", "self_transfer",
               "block17")]
    lanes = [p.shape[0] * p.shape[1] for p, *_ in tables]
    for chunk_lanes, slots in RING_GEOMETRY:
        assert max(-(-n // chunk_lanes) for n in lanes) > slots
    assert any(n % 32 for n in lanes) and any(n * 28 % 16 for n in lanes)
    assert any(len(hi) % 4 for _, hi, _, _ in tables)


def test_wave_plan_picks_each_branch(wave_lib):
    """The kernel's plan (csrc wave_plan) at phase 11's shapes: the
    bank's waves one warp over a resident table with the balances in
    shared memory; the random block (64 x 256 staged) a ring of
    four-wave chunks with a producer warp; 32,768 account slots in device
    memory beside a ring of the largest chunks; a chain of narrow waves
    a ring with one scanning warp; balances in shared memory at any
    shape up to 12,600 accounts; and never over 227 KB."""
    from firedancer_tpu_torch.ops import cuda_wave

    def plan(*a):
        p = cuda_wave.plan(*a, lib=wave_lib)
        assert p["smem"] <= 227 * 1024
        assert p["threads"] == p["scan_threads"] + 32 * p["ring"] <= 1024
        return p
    for w, c, a in ((16, 16, 512), (4, 16, 64)):
        p = plan(w, c, a)
        assert (p["ring"], p["sbal"], p["slots"], p["threads"]) == \
            (0, 1, 1, 32)
    p = plan(64, 256, 1024)          # chunks of four waves
    assert (p["ring"], p["sbal"], p["chunk_lanes"], p["chunks"],
            p["threads"]) == (1, 1, 1024, 16, 288) and 5 <= p["slots"] < 16
    p = plan(8, 8192, 32768)          # wide waves: the largest chunks
    assert (p["ring"], p["sbal"], p["scan_threads"], p["threads"],
            p["chunk_lanes"]) == (1, 0, 992, 1024, 2048) and p["slots"] >= 2
    for c in (16, 256, 992, 8192):     # balances in shared memory to 12,600
        assert plan(64, c, 12600)["sbal"] == 1 and \
            plan(64, c, 40000)["sbal"] == 0
    p = plan(4096, 4, 8192)
    assert (p["ring"], p["scan_threads"], p["threads"]) == (1, 32, 64)
    assert plan(0, 0, 0)["chunks"] == 0


# -- SHA-256 and PoH (csrc/sha256.cu), BLAKE3 and lthash (csrc/blake3.cu) --

def _hash_fn(host_lib, src, name, argtypes):
    fn = getattr(host_lib(src), name)
    fn.argtypes = argtypes
    return fn


_ROW_ARGS = [VP, ct.c_int64, VP, VP, ct.c_int, ct.c_int]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [200, 203, *hc.SHA256_WIDTHS])
def test_sha256_source_matches_plain_and_hashlib(host_lib, width, offset):
    """Every padding edge and random lengths, at the paths' row widths and
    base offsets 0-3 (every row's address mod 16: the staged window, the
    byte offset inside its first word), against hashlib and
    sha2.sha256. The slot's bytes outside the row's block are garbage,
    so a byte past the length that reached a word would show."""
    fn = _hash_fn(host_lib, "sha256", "sha256_lane_host",
                  [VP, ct.c_int64, VP, VP, ct.c_int])
    lens = list(hc.SHA256_EDGES) + [width - 1, width] + list(
        np.random.default_rng(width).integers(0, width + 1, 12))
    msg, ln = hc.offset_rows(lens, width, offset, 50 + width)
    out = np.zeros((len(ln), 32), np.uint8)
    for lane in range(len(ln)):
        fn(msg.ctypes.data, width, ln.ctypes.data, out.ctypes.data, lane)
    np.testing.assert_array_equal(out, hc.sha256_want(msg, ln))
    np.testing.assert_array_equal(out, sha2.sha256(
        torch.from_numpy(np.ascontiguousarray(msg)),
        torch.from_numpy(ln)).numpy())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 16, 65])
def test_poh_hash_source_matches_host_chain(host_lib, n):
    """One PoH hash as the kernel's lane pair computes it (pair_step on
    an e-lane and an a-lane two rounds apart, the values crossing as the
    shuffles carry them; the padding literals, the folded schedule terms,
    round 0's new e from a constant) n times over a state ==
    host_poh_append and == the plain sha256 chained."""
    fn = _hash_fn(host_lib, "sha256", "poh_hashes_host", [VP, ct.c_int])
    for seed in range(3):
        start = np.random.default_rng(seed + 10 * n).bytes(32)
        state = np.frombuffer(start, np.uint8).copy()
        fn(state.ctypes.data, n)
        assert bytes(state) == poh.host_poh_append(start, n)
        plain = torch.from_numpy(np.frombuffer(start, np.uint8).copy())[None]
        for _ in range(n):
            plain = sha2.sha256(plain, torch.tensor([32], dtype=torch.int32))
        assert bytes(state) == bytes(plain[0].numpy())


@pytest.mark.parametrize("max_hashes", [16, 64])
def test_poh_verify_source_matches_plain(host_lib, max_hashes):
    """Ticks, mixins, a mixin of one hash, 0 hashes, entries clipped at
    max_hashes and flipped expected bytes: the verdicts of
    poh.poh_verify_plain and of the host chain."""
    fn = _hash_fn(host_lib, "sha256", "poh_verify_host",
                  [VP] * 6 + [ct.c_int, ct.c_int])
    (prev, num, mix, has, exp), want = hc.poh_entries(max_hashes, 3)
    has8 = has.astype(np.uint8)
    ok = np.zeros(len(num), np.uint8)
    for i in range(len(num)):
        fn(prev.ctypes.data, num.ctypes.data, mix.ctypes.data,
           has8.ctypes.data, exp.ctypes.data, ok.ctypes.data, max_hashes, i)
    np.testing.assert_array_equal(ok.astype(bool), want)
    plain = poh.poh_verify_plain(
        *(torch.from_numpy(x) for x in (prev, num, mix, has, exp)),
        max_hashes)
    np.testing.assert_array_equal(ok.astype(bool), plain.numpy())


@pytest.mark.parametrize("width,aligned", [(2048, 1), (2048, 0), (1027, 0)])
def test_blake3_source_matches_plain_and_oracle(host_lib, width, aligned):
    """The block and chunk edges (one chunk re-runs its last block as the
    root; two chunks end in the parent merge), both load paths, against
    blake3_ref and blake3.blake3_plain."""
    fn = _hash_fn(host_lib, "blake3", "blake3_lane_host", _ROW_ARGS)
    msg, ln = hc.rows(hc.BLAKE3_EDGES, width, 60 + width)
    out = np.zeros((len(ln), 32), np.uint8)
    for i in range(len(ln)):
        fn(msg.ctypes.data, width, ln.ctypes.data, out.ctypes.data, aligned,
           i)
    np.testing.assert_array_equal(out, hc.blake3_want(msg, ln))
    np.testing.assert_array_equal(out, blake3.blake3_plain(
        torch.from_numpy(msg), torch.from_numpy(ln)).numpy())


@pytest.mark.parametrize("width,aligned", [(2048, 1), (1027, 0)])
def test_lthash_source_matches_plain_and_oracle(host_lib, width, aligned):
    """The 32 output counters of a message, lanes (w & 0xFFFF, w >> 16)
    counter-major, against blake3_ref.lthash and blake3.lthash_plain."""
    fn = _hash_fn(host_lib, "blake3", "lthash_lane_host", _ROW_ARGS)
    msg, ln = hc.rows(hc.BLAKE3_EDGES, width, 70 + width)
    out = np.zeros((len(ln), 1024), np.int32)
    for i in range(len(ln)):
        fn(msg.ctypes.data, width, ln.ctypes.data, out.ctypes.data, aligned,
           i)
    np.testing.assert_array_equal(out, hc.lthash_want(msg, ln))
    np.testing.assert_array_equal(out, blake3.lthash_plain(
        torch.from_numpy(msg), torch.from_numpy(ln)).numpy())


# the kernel's tile of 16 messages: chunks over groups of four lanes, the
# staged load, the root state once a message, then the digests or the XOF
_B3_WIDTHS = (2048, 1027, hc.BLAKE3_BANK_HASH_LEN)


def _b3_tile(host_lib):
    """Messages a block of the kernel takes."""
    fn = _hash_fn(host_lib, "blake3", "b3_tile_messages_host", [])
    fn.restype = ct.c_int
    return fn()


def _b3_tile_run(host_lib, msg, ln, xof):
    """Every tile of the batch through b3_tile_host (the kernel's block:
    its task table, each chunk's chain on a group stepped lane by lane,
    the root area, then the root compressions or the XOF)."""
    fn = _hash_fn(host_lib, "blake3", "b3_tile_host",
                  [VP, ct.c_int64, VP, VP, ct.c_int, ct.c_int, ct.c_int])
    n, width = msg.shape
    out = np.zeros((n, 1024), np.int32) if xof else np.zeros((n, 32),
                                                             np.uint8)
    for base in range(0, n, _b3_tile(host_lib)):
        fn(msg.ctypes.data, width, ln.ctypes.data, out.ctypes.data, n, base,
           xof)
    return out


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", _B3_WIDTHS)
@pytest.mark.parametrize("entry", ["blake3", "lthash"])
def test_blake3_tile_source_matches_plain_and_oracle(host_lib, entry, width,
                                                     offset):
    """Every block and chunk edge, the bank hash's 81 bytes and random
    lengths over one or two tiles (the last in part), rows at base offsets
    0-3 (every row's address mod 16: the staged window, the byte offset
    inside its first word), against blake3_ref and the plain versions."""
    lens = list(hc.BLAKE3_EDGES) + [hc.BLAKE3_BANK_HASH_LEN] + list(
        np.random.default_rng(width + offset).integers(0, width + 1, 8))
    msg, ln = hc.offset_rows(lens, width, offset, 80 + width + offset)
    assert msg.ctypes.data % 16 == offset
    xof = entry == "lthash"
    got = _b3_tile_run(host_lib, msg, ln, xof)
    want = hc.lthash_want(msg, ln) if xof else hc.blake3_want(msg, ln)
    np.testing.assert_array_equal(got, want)
    plain = blake3.lthash_plain if xof else blake3.blake3_plain
    np.testing.assert_array_equal(got, plain(
        torch.from_numpy(np.ascontiguousarray(msg)),
        torch.from_numpy(ln)).numpy())


@pytest.mark.parametrize("case", ["two_chunks", "one_chunk", "one_message",
                                  "bank_hash"])
def test_blake3_tile_task_tables_match_plain(host_lib, case):
    """The task table's extremes: a tile of two-chunk messages (a task
    for every group), a tile of one-chunk messages (half the groups), a
    tile of one message, and 80 bank-hash rows of 81 bytes (full tiles
    and a part)."""
    t = _b3_tile(host_lib)
    lens, width = {"two_chunks": ([2048, 1025] * (t // 2), 2048),
                   "one_chunk": ([1024, 1, 0, 64] * (t // 4), 2048),
                   "one_message": ([1500], 2048),
                   "bank_hash": ([81] * 80, 81)}[case]
    msg, ln = hc.rows(lens, width, 90 + len(lens))
    for xof, want, plain in ((0, hc.blake3_want, blake3.blake3_plain),
                             (1, hc.lthash_want, blake3.lthash_plain)):
        got = _b3_tile_run(host_lib, msg, ln, xof)
        np.testing.assert_array_equal(got, want(msg, ln))
        np.testing.assert_array_equal(got, plain(
            torch.from_numpy(msg), torch.from_numpy(ln)).numpy())


@pytest.mark.parametrize("seed", range(6))
def test_blake3_group_compress_source_matches_plain(host_lib, seed):
    """One compression on a group of lanes (the column and diagonal G
    functions, a, c and d into the diagonals and back, from the lane's
    own columns or by the kernel's shuffles, each lane's message words in
    its own order) == the plain version's
    compression, at counters, block lengths and flags of every kind."""
    fn = _hash_fn(host_lib, "blake3", "b3_group_compress_host",
                  [VP, VP, ct.c_uint32, ct.c_uint32, ct.c_uint32])
    rng = np.random.default_rng(seed)
    ctr = [0, 1, 31, 0, 1, 7][seed]
    blen = [64, 64, 17, 0, 64, 1][seed]
    flags = [1, 2, 8 | 2, 1 | 2, 4 | 8, 1][seed]
    cv = rng.integers(0, 1 << 32, 8, np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << 32, 16, np.uint64).astype(np.uint32)
    got = cv.copy()
    fn(got.ctypes.data, m.ctypes.data, ctr, blen, flags)
    want = blake3._compress([torch.tensor([int(x)]) for x in cv],
                            [torch.tensor([int(x)]) for x in m], ctr, blen,
                            flags)
    np.testing.assert_array_equal(got, [int(w[0]) for w in want[:8]])


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("width", _B3_WIDTHS)
def test_blake3_staged_load_source_matches_plain(host_lib, width, offset):
    """Each block of each chunk as a group stages it (the live 16-byte
    pieces of its 16-aligned window into a slot of garbage, each lane's
    four words by byte selects, the bytes past the length masked) == the
    plain version's block words, at every edge and base offsets 0-3."""
    fn = _hash_fn(host_lib, "blake3", "b3_stage_host",
                  [VP, ct.c_int, ct.c_int, ct.c_int, VP])
    lens = list(hc.BLAKE3_EDGES) + [hc.BLAKE3_BANK_HASH_LEN, width - 1]
    msg, ln = hc.offset_rows(lens, width, offset, 110 + width + offset)
    mt, lt = torch.from_numpy(np.ascontiguousarray(msg)), torch.from_numpy(ln)
    got = np.zeros(16, np.uint32)
    for i, n in enumerate(ln):
        for c in range(2 if n > 1024 else 1):
            clen = n - 1024 if c else min(n, 1024)
            for b in range(max(1, -(-clen // 64))):
                fn(msg.ctypes.data + i * width, int(n), c, b, got.ctypes.data)
                want = blake3._block_words(mt[i:i + 1], 1024 * c + 64 * b,
                                           lt[i:i + 1])
                assert [int(w[0]) for w in want] == got.tolist(), (n, c, b)
