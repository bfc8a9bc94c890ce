"""Reed-Solomon erasure coding as one bit-matrix product (counterpart of
the JAX package's ops/reedsol.py:36-104, whose product XLA computes as an
einsum outside any Pallas kernel; here it is `torch.matmul` on the
tensors' device).

GF(2^8) is an 8-dimensional vector space over GF(2), and multiplication
by a constant is GF(2)-linear. Expanding every shred byte into its 8 bits
turns the (p, d) GF parity matrix M into a constant (8p, 8d) 0/1 matrix
B[(r,k),(j,b)] = bit_k(M[r,j] * x^b mod poly), and encoding becomes

    parity_bits = (B @ data_bits) mod 2

— one float32 product, batched over shred sets and byte positions, and a
parity mask. It is exact: the inputs are 0 and 1 (exact in TF32 too) and a
sum is at most 8 * 67 = 536. Recovery applies the same product with the
host-computed inverse of an erasure pattern (utils/gf256.recovery_matrix).
The bit matrices are built on the host, as in the reference.

Matches utils/gf256 (the host oracle pinned to the reference's
construction, src/ballet/reedsol/gen_tbls.py:7-11) byte for byte.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as _device
from ..utils import gf256

# gf_mul(c, x^b) for every byte c and bit b
_MUL_X = np.array([[gf256.gf_mul(c, 1 << b) for b in range(8)]
                   for c in range(256)], np.int64)


def _bit_matrix(m: np.ndarray) -> np.ndarray:
    """(p, d) GF matrix -> (8p, 8d) 0/1 float32 bit matrix, entry
    (8r + k, 8j + b) = bit k of m[r, j] * x^b."""
    p, d = m.shape
    bits = (_MUL_X[m.astype(np.int64)][..., None] >> np.arange(8)) & 1
    return bits.transpose(0, 3, 1, 2).reshape(8 * p, 8 * d) \
        .astype(np.float32)                       # (r, k, j, b)


@functools.lru_cache(maxsize=None)
def _parity_bit_matrix(d: int, p: int) -> np.ndarray:
    return _bit_matrix(gf256.parity_matrix(d, p))


def _apply_bit_matrix(mat_bits: np.ndarray, shreds: torch.Tensor):
    """codes = mat @ shreds over GF(2^8): mat_bits (8out, 8in) float32,
    shreds (..., in, sz) uint8 -> (..., out, sz) uint8 on shreds' device."""
    dev = shreds.device
    sh = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = (shreds.unsqueeze(-2) >> sh.unsqueeze(-1)) & 1  # (..., in, 8, sz)
    bits = bits.reshape(*shreds.shape[:-2], shreds.shape[-2] * 8,
                        shreds.shape[-1]).to(torch.float32)
    acc = torch.matmul(torch.from_numpy(mat_bits).to(dev), bits)
    par = (acc.to(torch.int32) & 1).to(torch.uint8)
    par = par.reshape(*par.shape[:-2], par.shape[-2] // 8, 8, par.shape[-1])
    w = (torch.ones(8, dtype=torch.uint8, device=dev) << sh).unsqueeze(-1)
    return (par * w).sum(dim=-2, dtype=torch.uint8)


def _as_bytes(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.uint8,
                           device=_device.resolve(device))


def encode(data, p: int, device="cuda") -> torch.Tensor:
    """data (..., d, sz) uint8 shred set(s), numpy or tensor -> (..., p,
    sz) uint8 parity on `device`. Byte-identical to the reference
    construction for any (d, p) up to the 67/67 maxima."""
    data = _as_bytes(data, device)
    return _apply_bit_matrix(_parity_bit_matrix(data.shape[-2], p), data)


def recover(shreds, present: tuple[int, ...], d: int, p: int,
            device="cuda") -> torch.Tensor:
    """Rebuild the d data shreds from d surviving shreds: shreds (..., d,
    sz) uint8, the survivors in index order (indices `present`, sorted,
    into the d + p codeword) -> (..., d, sz) uint8 data on `device`."""
    r = gf256.recovery_matrix(d, p, list(present))
    return _apply_bit_matrix(_bit_matrix(r), _as_bytes(shreds, device))
