"""Wrappers of the SHA-256 kernel's two entries (csrc/sha256.cu): `sha256`,
the digest of (B, L) rows (replaces the JAX package's jitted
ops/sha2.py:211 `sha256`), and `poh_verify`, the batched PoH entry
verdicts (replaces ops/poh.py:41 `poh_verify_entries`'s scan).

A CPU tensor goes to the plain version (ops/sha2.py `sha256`, ops/poh.py
`poh_verify_plain`); a CUDA tensor goes to the kernel, or the call
raises. `launches` counts kernel launches and nothing else, by entry."""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build, poh, sha2
from .cuda_sha import check

launches = {"sha256": 0, "poh_verify": 0}

_ARGS = [ct.c_void_p, ct.c_longlong, ct.c_void_p, ct.c_void_p, ct.c_int,
         ct.c_void_p]
_POH_ARGS = [ct.c_void_p] * 6 + [ct.c_int, ct.c_int, ct.c_void_p]


def sha256(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L) uint8, msg_len (B,) int32 -> (B, 32) uint8 digests of
    msg[i, :msg_len[i]]."""
    dev = msg.device
    if dev.type == "cpu":
        return sha2.sha256(msg, msg_len)
    if dev.type != "cuda":
        raise ValueError(f"sha256: tensors on {dev}; expected CUDA")
    b = msg.shape[0] if msg.dim() == 2 else -1
    check("sha256", "msg", msg, dev, torch.uint8, (b, None))
    check("sha256", "msg_len", msg_len, dev, torch.int32, (b,))
    fn = _build.lib("sha256", _ARGS)
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = fn(msg.data_ptr(), msg.shape[1], msg_len.data_ptr(),
                out.data_ptr(), b, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("sha256", rc)
    launches["sha256"] += 1
    return out


def poh_verify(prev, num_hashes, mixin, has_mixin, expected,
               max_hashes: int) -> torch.Tensor:
    """prev, mixin, expected (N, 32) uint8, num_hashes (N,) int32,
    has_mixin (N,) bool -> (N,) bool: each entry's chain from prev,
    min(n_plain, max_hashes) plain hashes and the mixin hash, equals
    expected, and num_hashes >= 1 (ops/poh.py `poh_verify_plain`)."""
    dev = prev.device
    if dev.type == "cpu":
        return poh.poh_verify_plain(prev, num_hashes, mixin, has_mixin,
                                    expected, max_hashes)
    if dev.type != "cuda":
        raise ValueError(f"poh_verify: tensors on {dev}; expected CUDA")
    n = prev.shape[0]
    for name, t, dtype, shape in (
            ("prev", prev, torch.uint8, (n, 32)),
            ("num_hashes", num_hashes, torch.int32, (n,)),
            ("mixin", mixin, torch.uint8, (n, 32)),
            ("has_mixin", has_mixin, torch.bool, (n,)),
            ("expected", expected, torch.uint8, (n, 32))):
        check("poh_verify", name, t, dev, dtype, shape)
    fn = _build.lib("sha256", _POH_ARGS, "fdtt_poh_verify")
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = fn(prev.data_ptr(), num_hashes.data_ptr(), mixin.data_ptr(),
                has_mixin.data_ptr(), expected.data_ptr(), ok.data_ptr(),
                n, int(max_hashes), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("poh_verify", rc)
    launches["poh_verify"] += 1
    return ok
