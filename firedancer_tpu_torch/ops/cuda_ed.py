"""Wrapper of the fused strict verify kernel (csrc/ed25519_verify.cu;
replaces firedancer_tpu/ops/pallas_ed.py `_verify_kernel`), and the
strict glue `verify_batch` that drives it (counterpart of
pallas_ed.verify_batch, pallas_ed.py:719-744).

A CPU tensor goes to the plain version (ops/ed25519.py `verify_core`); a
CUDA tensor goes to the kernel, or the call raises. `launches` counts
kernel launches and nothing else."""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build, cuda_sha
from . import ed25519 as ed
from .params import fixed_base_tables

launches = 0

_ARGS = [ct.c_void_p] * 5 + [ct.c_int, ct.c_void_p]


def _check(name, t, shape):
    if t.dtype != torch.uint8 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"verify_core: {name} must be a contiguous "
                         f"{shape} uint8, got {t.dtype} {tuple(t.shape)}")


def verify_core(sig: torch.Tensor, pub: torch.Tensor,
                k64: torch.Tensor) -> torch.Tensor:
    """sig (B, 64), pub (B, 32), k64 (B, 64) uint8 -> (B,) int32 core
    verdicts (decompression of A and the group equation, no glue
    masks)."""
    global launches
    dev = sig.device
    if dev.type == "cpu":
        return ed.verify_core(sig, pub, k64, fixed_base_tables(dev))
    if dev.type != "cuda" or pub.device != dev or k64.device != dev:
        raise ValueError("verify_core: tensors must share one CUDA device")
    b = sig.shape[0]
    _check("sig", sig, (b, 64))
    _check("pub", pub, (b, 32))
    _check("k64", k64, (b, 64))
    fn = _build.lib("ed25519_verify", _ARGS)
    tab = fixed_base_tables(dev)
    out = torch.empty(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(sig.data_ptr(), pub.data_ptr(), k64.data_ptr(),
                tab.data_ptr(), out.data_ptr(), b,
                torch.cuda.current_stream().cuda_stream)
    _build.check_launch("ed25519_verify", rc)
    launches += 1
    return out


def verify_batch(sig, pub, msg, msg_len, device="cuda"):
    """Batched strict ed25519 verify through the kernels.

    sig (B, 64), pub (B, 32), msg (B, L) uint8 (zero past each length),
    msg_len (B,) int32; numpy arrays or tensors. -> (B,) bool on
    `device`. device="cpu" runs the plain versions; "cuda" without a
    card raises."""
    sig, pub, msg, msg_len = ed.as_inputs(sig, pub, msg, msg_len, device)
    return ed.strict_verify(sig, pub, msg, msg_len, cuda_sha.sha512,
                            verify_core)
