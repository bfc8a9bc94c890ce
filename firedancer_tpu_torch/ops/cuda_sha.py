"""Wrappers of the SHA-512 kernel (csrc/sha512.cu; replaces
firedancer_tpu/ops/pallas_sha.py `_sha512_kernel` and the strict glue of
pallas_ed.verify_batch around it): `sha512_ram`, which hashes R || A || M
read in place from sig, pub and msg and runs the strict prechecks, and
`sha512`, the generic digest of (B, L) rows.

A CPU tensor goes to the plain version (ops/sha2.py); a CUDA tensor goes
to the kernel, or the call raises. `launches` counts kernel launches and
nothing else: "sha512" every launch of the kernel, through either entry,
and "sha512_ram" those through the in-place entry."""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build, sha2

launches = {"sha512": 0, "sha512_ram": 0}

_ARGS = [ct.c_void_p, ct.c_longlong, ct.c_void_p, ct.c_void_p, ct.c_int,
         ct.c_void_p]
_ARGS_RAM = [ct.c_void_p] * 3 + [ct.c_longlong] + [ct.c_void_p] * 3 \
    + [ct.c_int, ct.c_void_p]


def check(fn, name, t, dev, dtype, shape):
    """Raise ValueError unless `t` is a contiguous tensor of `dtype` on
    `dev` whose shape matches `shape` (None matches any size)."""
    if t.device != dev or t.dtype != dtype or t.dim() != len(shape) \
            or any(w is not None and w != s for w, s in zip(shape, t.shape)) \
            or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {shape} {dtype} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def sha512(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L) uint8, msg_len (B,) int32 -> (B, 64) uint8 digests."""
    dev = msg.device
    if dev.type == "cpu":
        return sha2.sha512(msg, msg_len)
    if dev.type != "cuda":
        raise ValueError(f"sha512: tensors on {dev}; expected CUDA")
    b = msg.shape[0] if msg.dim() == 2 else -1
    check("sha512", "msg", msg, dev, torch.uint8, (b, None))
    check("sha512", "msg_len", msg_len, dev, torch.int32, (b,))
    fn = _build.lib("sha512", _ARGS)
    out = torch.empty((b, 64), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = fn(msg.data_ptr(), msg.shape[1], msg_len.data_ptr(),
                out.data_ptr(), b, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("sha512", rc)
    launches["sha512"] += 1
    return out


def sha512_ram(sig: torch.Tensor, pub: torch.Tensor, msg: torch.Tensor,
               msg_len: torch.Tensor):
    """sig (B, 64), pub (B, 32), msg (B, L) uint8, msg_len (B,) int32 ->
    (k64 (B, 64) uint8 = SHA-512(sig[:, :32] || pub || msg[:, :msg_len]),
    pre (B,) int32 = S < l, A.y < p, A and R not small-order)."""
    dev = sig.device
    if dev.type == "cpu":
        return sha2.sha512_ram(sig, pub, msg, msg_len)
    if dev.type != "cuda":
        raise ValueError(f"sha512_ram: tensors on {dev}; expected CUDA")
    b = sig.shape[0]
    for name, t, dtype, shape in (("sig", sig, torch.uint8, (b, 64)),
                                  ("pub", pub, torch.uint8, (b, 32)),
                                  ("msg", msg, torch.uint8, (b, None)),
                                  ("msg_len", msg_len, torch.int32, (b,))):
        check("sha512_ram", name, t, dev, dtype, shape)
    fn = _build.lib("sha512", _ARGS_RAM, "fdtt_sha512_ram")
    k64 = torch.empty((b, 64), dtype=torch.uint8, device=dev)
    pre = torch.empty(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(sig.data_ptr(), pub.data_ptr(), msg.data_ptr(),
                msg.shape[1], msg_len.data_ptr(), k64.data_ptr(),
                pre.data_ptr(), b, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("sha512_ram", rc)
    launches["sha512"] += 1
    launches["sha512_ram"] += 1
    return k64, pre
