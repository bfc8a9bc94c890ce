"""The kernels' C++ sources compiled for the host and held against their
plain PyTorch versions lane by lane.

csrc/sha512.cu and csrc/ed25519_verify.cu compile as plain C++ when nvcc
is absent (__CUDACC__ unset): each kernel becomes a host function of one
lane. That checks the sources' arithmetic (padding, big-endian loads,
limb carries, scalar reduction, window walk, canonical compare) here,
where there is no card; launch, memory and timing are checked on the
card by chip_smoke.py and tests/test_torch_cuda.py. Exact: digests and
verdicts are integers."""
import ctypes as ct
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import params, sha2
from firedancer_tpu_torch.ops._build import CSRC
from firedancer_tpu_torch.utils import ed25519_ref as ref

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


def test_sha512_source_matches_plain_and_hashlib(host_lib):
    lib = host_lib("sha512")
    fn = lib.sha512_kernel
    fn.argtypes = [VP, ct.c_int64, VP, VP, ct.c_int, ct.c_int, ct.c_int]
    rng = np.random.default_rng(41)
    width = 1296
    lens = np.array([0, 1, 111, 112, 127, 128, 239, 240, 1296]
                    + list(rng.integers(0, width + 1, 15)), np.int32)
    msg = rng.integers(0, 256, (len(lens), width), np.uint8)
    msg[np.arange(width)[None, :] >= lens[:, None]] = 0
    plain = sha2.sha512(torch.from_numpy(msg), torch.from_numpy(lens))
    for aligned in (0, 1):
        out = np.zeros((len(lens), 64), np.uint8)
        for lane in range(len(lens)):
            fn(msg.ctypes.data, width, lens.ctypes.data, out.ctypes.data,
               len(lens), aligned, lane)
        np.testing.assert_array_equal(out, plain.numpy())
    for i, n in enumerate(lens):
        assert bytes(out[i]) == hashlib.sha512(bytes(msg[i, :n])).digest()


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
