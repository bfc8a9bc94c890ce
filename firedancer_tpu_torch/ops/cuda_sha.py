"""Wrapper of the SHA-512 kernel (csrc/sha512.cu; replaces
firedancer_tpu/ops/pallas_sha.py `_sha512_kernel`).

A CPU tensor goes to the plain version (ops/sha2.py `sha512`); a CUDA
tensor goes to the kernel, or the call raises. `launches` counts kernel
launches and nothing else."""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from .sha2 import sha512 as sha512_plain

launches = 0

_ARGS = [ct.c_void_p, ct.c_longlong, ct.c_void_p, ct.c_void_p, ct.c_int,
         ct.c_void_p]


def sha512(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L) uint8, msg_len (B,) int32 -> (B, 64) uint8 digests."""
    global launches
    if msg.device.type == "cpu":
        return sha512_plain(msg, msg_len)
    if msg.device.type != "cuda" or msg_len.device != msg.device:
        raise ValueError(f"sha512: tensors on {msg.device} and "
                         f"{msg_len.device}; expected one CUDA device")
    if msg.dtype != torch.uint8 or msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError("sha512: msg must be a contiguous (B, L) uint8")
    if msg_len.dtype != torch.int32 or msg_len.shape != msg.shape[:1] \
            or not msg_len.is_contiguous():
        raise ValueError("sha512: msg_len must be a contiguous (B,) int32")
    fn = _build.lib("sha512", _ARGS)
    out = torch.empty((msg.shape[0], 64), dtype=torch.uint8,
                      device=msg.device)
    with torch.cuda.device(msg.device):
        rc = fn(msg.data_ptr(), msg.shape[1], msg_len.data_ptr(),
                out.data_ptr(), msg.shape[0],
                torch.cuda.current_stream().cuda_stream)
    _build.check_launch("sha512", rc)
    launches += 1
    return out
