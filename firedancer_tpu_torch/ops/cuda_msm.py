"""Wrappers of the two RLC MSM kernels (csrc/ed25519_msm.cu; they replace
firedancer_tpu/ops/pallas_msm.py `_msm_stage1_kernel` and
`_msm_stage2_kernel`, with the scalar glue of pallas_msm.py:307-327
inside them), and the RLC batch verify that drives them
(counterpart of pallas_msm.rlc_verify_batch_tpu and
verify_batch_rlc_tpu, pallas_msm.py:296-376).

A CPU tensor goes to the plain version (ops/msm.py); a CUDA tensor goes
to the kernel, or the call raises. `launches` counts kernel launches per
kernel and nothing else."""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from . import _build, cuda_ed, cuda_sha, msm
from . import ed25519 as ed
from .params import fixed_base_tables

launches = {"msm_stage1": 0, "msm_stage2": 0}

_ARGS1 = [ct.c_void_p] * 7 + [ct.c_int, ct.c_void_p]
_ARGS2 = [ct.c_void_p, ct.c_int] + [ct.c_void_p] * 5
_TOTALS = 64 * 4 * 10       # stage 2's window totals in its scratch


def _check(fn, name, t, shape, dtype, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {shape} {dtype} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def msm_stage1(pub, sig, k64, z):
    """pub (B, 32), sig (B, 64), k64 (B, 64), z (B, 16) uint8 -> (wsum
    (ceil(B / 64), 64, 4, 10) int32, lane_ok (B,) int32, sdig
    (ceil(B / 64), 13) int64)."""
    dev = pub.device
    if dev.type == "cpu":
        return msm.msm_stage1(pub, sig, k64, z)
    if dev.type != "cuda":
        raise ValueError(f"msm_stage1: tensors on {dev}; expected CUDA")
    b = pub.shape[0]
    if b == 0:
        raise ValueError("msm_stage1: empty batch")
    for name, t, shape in (("pub", pub, (b, 32)), ("sig", sig, (b, 64)),
                           ("k64", k64, (b, 64)), ("z", z, (b, 16))):
        _check("msm_stage1", name, t, shape, torch.uint8, dev)
    fn = _build.lib("ed25519_msm", _ARGS1, "fdtt_msm_stage1")
    nblk = -(-b // msm.LANES)
    wsum = torch.empty((nblk, 64, 4, 10), dtype=torch.int32, device=dev)
    lane_ok = torch.empty(b, dtype=torch.int32, device=dev)
    sdig = torch.empty((nblk, 13), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = fn(pub.data_ptr(), sig.data_ptr(), k64.data_ptr(), z.data_ptr(),
                wsum.data_ptr(), lane_ok.data_ptr(), sdig.data_ptr(), b,
                torch.cuda.current_stream().cuda_stream)
    _build.check_launch("msm_stage1", rc)
    launches["msm_stage1"] += 1
    return wsum, lane_ok, sdig


def msm_stage2(wsum, sdig):
    """wsum (nblk, 64, 4, 10) int32, sdig (nblk, 13) int64 -> (ok ()
    int32, point (4, 10) int32 canonical limbs of the batch sum)."""
    dev = wsum.device
    tab = fixed_base_tables(dev)
    if dev.type == "cpu":
        return msm.msm_stage2(wsum, sdig, tab)
    if dev.type != "cuda":
        raise ValueError(f"msm_stage2: tensors on {dev}; expected CUDA")
    nblk = wsum.shape[0]
    if nblk == 0:
        raise ValueError("msm_stage2: no blocks")
    _check("msm_stage2", "wsum", wsum, (nblk, 64, 4, 10), torch.int32, dev)
    _check("msm_stage2", "sdig", sdig, (nblk, 13), torch.int64, dev)
    fn = _build.lib("ed25519_msm", _ARGS2, "fdtt_msm_stage2")
    buf = torch.empty(41 + _TOTALS + 1, dtype=torch.int32, device=dev)
    out, scratch = buf[:41], buf[41:]      # scratch: totals and a ticket
    with torch.cuda.device(dev):
        rc = fn(wsum.data_ptr(), nblk, sdig.data_ptr(), tab.data_ptr(),
                scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_launch("msm_stage2", rc)
    launches["msm_stage2"] += 1
    return out[0], out[1:].view(4, 10)


def rlc_verify_batch(sig, pub, msg, msg_len, z_bytes, device="cuda"):
    """RLC batch verification through the kernels (SHA-512 and the two
    MSM stages, with no scalar work between them). Arguments and result
    as ops/ed25519.py `rlc_verify_batch`; device="cpu" runs the plain
    versions, "cuda" without a card raises."""
    sig, pub, msg, msg_len = ed.as_inputs(sig, pub, msg, msg_len, device)
    z = torch.as_tensor(z_bytes, dtype=torch.uint8,
                        device=sig.device).contiguous()
    return ed.rlc_verify(sig, pub, msg, msg_len, z, cuda_sha.sha512_ram,
                         msm_stage1, msm_stage2)


def verify_batch_rlc(sig, pub, msg, msg_len, rng=None, device="cuda"):
    """The RLC fast path with the strict kernels as fallback (ops/ed25519.py
    `verify_batch_rlc` through the kernels). -> (B,) bool on `device`."""
    rng = rng or np.random.default_rng()
    z = rng.integers(0, 256, (sig.shape[0], 16), dtype=np.uint8)
    ok, lane_pre = rlc_verify_batch(sig, pub, msg, msg_len, z, device)
    if bool(ok):
        return lane_pre
    return cuda_ed.verify_batch(sig, pub, msg, msg_len, device)
