"""Batched BLAKE3 and lthash (counterpart of the JAX package's
ops/blake3.py:139-184): `blake3_batch` and `lthash_batch` on the BLAKE3
kernel's two entries (csrc/blake3.cu, wrapped by ops/cuda_blake3.py) on
the card, their plain versions `blake3_plain` and `lthash_plain` on the
CPU; and the wrapping lane arithmetic `lthash_add`, `lthash_sub` and
`lthash_reduce`.

Messages go up to two chunks (2,048 bytes: a transaction, MTU 1232, or an
account-delta leaf); a wider row raises ValueError, as the reference's
does. Longer inputs use the host oracle (utils/blake3_ref.py).

lthash (ref: src/ballet/lthash/fd_lthash.h): the XOF to 2,048 bytes (32
root compressions with output counter 0..31) read as 1,024 16-bit lanes,
each word w giving (w & 0xFFFF, w >> 16), counter-major. The port carries
the lanes as int32 in [0, 2^16) (torch.uint16 supports few operations);
add, sub and reduce wrap mod 2^16 explicitly.

The plain versions keep 32-bit words in int64 tensors masked to 32 bits,
and compress every block position of both chunks for every lane, masked
past each lane's own count, as the reference's `_root_state` does."""
from __future__ import annotations

import torch

from .. import device as _device
from ..utils.blake3_ref import (
    BLOCK_LEN, CHUNK_END, CHUNK_LEN, CHUNK_START, IV, MSG_PERM, PARENT, ROOT,
)

MAX_LEN = 2 * CHUNK_LEN
LTHASH_LANES = 1024
_M32 = 0xFFFFFFFF


def check_width(width: int):
    if width > MAX_LEN:
        raise ValueError(f"batched blake3 caps at {MAX_LEN} bytes, got "
                         f"rows of {width}")


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(cv, m, counter, block_len, flags):
    """(B,) int64 word lists and tensors -> the 16 output words."""
    z = torch.zeros_like(cv[0])
    v = list(cv) + [z + IV[i] for i in range(4)] + [
        z + counter, z, z + block_len, z + flags]
    m = list(m)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in MSG_PERM]
    return [v[i] ^ v[i + 8] for i in range(8)] \
        + [v[i + 8] ^ cv[i] for i in range(8)]


def _block_words(msg, off: int, msg_len):
    """The 16 little-endian (B,) words of the 64-byte block at `off`,
    bytes past each lane's length zeroed."""
    b, width = msg.shape
    blk = torch.zeros((b, BLOCK_LEN), dtype=torch.int64, device=msg.device)
    take = min(BLOCK_LEN, width - off)
    if take > 0:
        idx = torch.arange(off, off + take, device=msg.device)
        blk[:, :take] = torch.where(idx < msg_len.unsqueeze(-1),
                                    msg[:, off:off + take].to(torch.int64),
                                    0)
    w = blk.reshape(b, 16, 4)
    return [w[:, i, 0] | (w[:, i, 1] << 8) | (w[:, i, 2] << 16)
            | (w[:, i, 3] << 24) for i in range(16)]


def _root_state(msg, msg_len):
    """-> (cv, m, block_len, flags) of each lane's ROOT compression, the
    ROOT flag and the output counter left to the caller."""
    check_width(msg.shape[1])
    bsz = msg.shape[0]
    msg_len = msg_len.to(torch.int64)
    single = msg_len <= CHUNK_LEN
    z = torch.zeros(bsz, dtype=torch.int64, device=msg.device)

    def chunk_cv(c):
        """Chaining value of chunk c, and the last block's inputs."""
        clen = torch.clamp(msg_len - c * CHUNK_LEN, 0, CHUNK_LEN)
        nb = torch.clamp((clen + BLOCK_LEN - 1) // BLOCK_LEN, min=1)
        cv = [z + IV[i] for i in range(8)]
        fin = None
        for bi in range(CHUNK_LEN // BLOCK_LEN):
            off = c * CHUNK_LEN + bi * BLOCK_LEN
            if off >= msg.shape[1] and bi > 0:
                break
            m = _block_words(msg, min(off, msg.shape[1]), msg_len)
            blen = torch.clamp(clen - bi * BLOCK_LEN, 0, BLOCK_LEN)
            is_last = nb - 1 == bi
            flags = (CHUNK_START if bi == 0 else 0) \
                | torch.where(is_last, CHUNK_END, 0)
            out = _compress(cv, m, c, blen, flags)
            active = bi < nb
            if fin is None:
                fin = (list(cv), m, blen, flags)
            else:
                upd = is_last & active
                fin = ([torch.where(upd, a, f) for a, f in zip(cv, fin[0])],
                       [torch.where(upd, a, f) for a, f in zip(m, fin[1])],
                       torch.where(upd, blen, fin[2]),
                       torch.where(upd, flags, fin[3]))
            cv = [torch.where(active, out[i], cv[i]) for i in range(8)]
        return cv, fin

    cv0, fin0 = chunk_cv(0)
    cv1, _ = chunk_cv(1)
    parent_m = cv0 + cv1
    cv = [torch.where(single, f, IV[i]) for i, f in enumerate(fin0[0])]
    m = [torch.where(single, a, b) for a, b in zip(fin0[1], parent_m)]
    blen = torch.where(single, fin0[2], BLOCK_LEN)
    flags = torch.where(single, fin0[3], PARENT)
    return cv, m, blen, flags


def blake3_plain(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L <= 2048) uint8 (zero-padded), msg_len (B,) int32 ->
    (B, 32) uint8 digests."""
    cv, m, blen, flags = _root_state(msg, msg_len)
    out = _compress(cv, m, 0, blen, flags | ROOT)[:8]
    words = torch.stack(out, dim=-1)                        # (B, 8)
    sh = torch.tensor([0, 8, 16, 24], device=msg.device)
    return ((words.unsqueeze(-1) >> sh) & 0xFF).to(torch.uint8) \
        .reshape(msg.shape[0], 32)


def lthash_plain(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L <= 2048) uint8, msg_len (B,) int32 -> (B, 1024) int32
    lanes in [0, 2^16)."""
    cv, m, blen, flags = _root_state(msg, msg_len)
    w = torch.stack([torch.stack(_compress(cv, m, ctr, blen, flags | ROOT),
                                 dim=-1) for ctr in range(32)], dim=1)
    w = w.reshape(msg.shape[0], 512)                        # counter-major
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1) \
        .reshape(msg.shape[0], LTHASH_LANES).to(torch.int32)


def _inputs(msg, msg_len, device):
    dev = _device.resolve(device)
    msg = torch.as_tensor(msg, dtype=torch.uint8, device=dev).contiguous()
    check_width(msg.shape[-1])
    return msg, torch.as_tensor(msg_len, dtype=torch.int32, device=dev)


def blake3_batch(msg, msg_len, device="cuda") -> torch.Tensor:
    """(B, L <= 2048) uint8 (zero-padded), (B,) int -> (B, 32) uint8 on
    `device`: the kernel on the card, the plain version on the CPU."""
    from .cuda_blake3 import blake3
    return blake3(*_inputs(msg, msg_len, device))


def lthash_batch(msg, msg_len, device="cuda") -> torch.Tensor:
    """(B, L <= 2048) uint8, (B,) int -> (B, 1024) int32 lanes in
    [0, 2^16) on `device` (the XOF-2048 lattice elements, ref
    fd_blake3_fini_2048 / fd_lthash.h)."""
    from .cuda_blake3 import lthash
    return lthash(*_inputs(msg, msg_len, device))


def lthash_add(acc: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(..., 1024) lanes, wrapping add mod 2^16 (homomorphic
    accumulate)."""
    return (acc + vals) & 0xFFFF


def lthash_sub(acc: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return (acc - vals) & 0xFFFF


def lthash_reduce(vals: torch.Tensor) -> torch.Tensor:
    """(N, 1024) lanes -> (1024,) their sum mod 2^16 (the snapshot
    pipeline's fan-in as one reduction), dtype kept."""
    return (vals.sum(dim=0, dtype=torch.int64) & 0xFFFF).to(vals.dtype)
