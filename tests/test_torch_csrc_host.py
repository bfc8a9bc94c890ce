"""The kernels' C++ sources compiled for the host and held against their
plain PyTorch versions lane by lane.

csrc/sha512.cu, csrc/ed25519_verify.cu and csrc/ed25519_msm.cu compile
as plain C++ when nvcc is absent (__CUDACC__ unset): each kernel's
per-lane part becomes a host function, and the threads that work
together on the card (the four threads of a group that carries one
signature, the threads of MSM stage 2) run one after another. That
checks the sources' arithmetic (padding, big-endian loads of R || A || M
from three rows, limb carries, prechecks, scalar reduction,
decompression, tables, window walk, chunked sums over blocks, Horner,
canonical compare) here, where there is no card; launch, the group's
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
from firedancer_tpu_torch.ops import msm, params, sha2
from firedancer_tpu_torch.ops._build import CSRC
from firedancer_tpu_torch.utils import ed25519_ref as ref
from torch_rlc_cases import (KEPT_OUT, PRE_CLASSES, ram_inputs,
                             spread_blocks, stage_inputs)

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
