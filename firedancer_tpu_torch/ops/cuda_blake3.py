"""Wrappers of the BLAKE3 kernel's two entries (csrc/blake3.cu): `blake3`,
the digests of (B, L <= 2048) rows (replaces the JAX package's jitted
ops/blake3.py:139 `blake3_batch`), and `lthash`, their 1,024 16-bit
lattice lanes as int32 (replaces :150 `lthash_batch`).

A CPU tensor goes to the plain version (ops/blake3.py `blake3_plain`,
`lthash_plain`); a CUDA tensor goes to the kernel, or the call raises. A
row wider than 2,048 bytes raises ValueError on either device.
`launches` counts kernel launches and nothing else, by entry."""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from . import blake3 as b3
from .cuda_sha import check

launches = {"blake3": 0, "lthash": 0}

_ARGS = [ct.c_void_p, ct.c_longlong, ct.c_void_p, ct.c_void_p, ct.c_int,
         ct.c_void_p]


def _launch(entry: str, msg, msg_len, out_shape, dtype):
    b3.check_width(msg.shape[-1])
    dev = msg.device
    if dev.type == "cpu":
        plain = b3.blake3_plain if entry == "blake3" else b3.lthash_plain
        return plain(msg, msg_len)
    if dev.type != "cuda":
        raise ValueError(f"{entry}: tensors on {dev}; expected CUDA")
    b = msg.shape[0] if msg.dim() == 2 else -1
    check(entry, "msg", msg, dev, torch.uint8, (b, None))
    check(entry, "msg_len", msg_len, dev, torch.int32, (b,))
    fn = _build.lib("blake3", _ARGS, f"fdtt_{entry}")
    out = torch.empty((b, *out_shape), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = fn(msg.data_ptr(), msg.shape[1], msg_len.data_ptr(),
                out.data_ptr(), b, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(entry, rc)
    launches[entry] += 1
    return out


def blake3(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L <= 2048) uint8, msg_len (B,) int32 -> (B, 32) uint8."""
    return _launch("blake3", msg, msg_len, (32,), torch.uint8)


def lthash(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L <= 2048) uint8, msg_len (B,) int32 -> (B, 1024) int32
    lanes in [0, 2^16)."""
    return _launch("lthash", msg, msg_len, (b3.LTHASH_LANES,), torch.int32)
