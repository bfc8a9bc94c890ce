"""The verify kernel's fixed-base table: the one piece of state carried
across from the JAX package.

Layout: (64, 16, 3, 10) int32, entry [j, w] = (Y - X, Y + X, 2d T) of
the affine point (w 16^j) B in the port's radix-2^25.5 limbs, canonical
(w = 0 is the identity (1, 1, 0)). 122,880 bytes: too large for the
64 KB constant bank, so the kernel reads it from global memory.

`from_jax_tables` converts the JAX package's tables
(pallas_ed._fb_tables(): three (64, 16, 20) int32 arrays in radix 2^13)
into this layout; `own_tables` generates it from the port's own
ed25519._fixed_base_table, and the two must be identical."""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import fe25519 as fe

_JAX_BITS = 13


def _pack(ymx_int, ypx_int, t2d_int) -> np.ndarray:
    out = np.zeros((64, 16, 3, fe.NLIMB), np.int32)
    for j in range(64):
        for w in range(16):
            for c, v in enumerate((ymx_int(j, w), ypx_int(j, w),
                                   t2d_int(j, w))):
                out[j, w, c] = fe.int_to_limbs(v % fe.P)
    return out


def from_jax_tables(ymx, ypx, t2d) -> np.ndarray:
    """Three (64, 16, 20) radix-2^13 limb arrays -> (64, 16, 3, 10)."""
    def val(a):
        a = np.asarray(a, np.int64)
        return lambda j, w: sum(int(v) << (_JAX_BITS * i)
                                for i, v in enumerate(a[j, w]))
    return _pack(val(ymx), val(ypx), val(t2d))


@functools.lru_cache(maxsize=None)
def own_tables() -> np.ndarray:
    """The same layout from the port's own fixed-base generator."""
    from .ed25519 import _fixed_base_table
    tab = _fixed_base_table()

    def coord(j, w, c):
        return fe.limbs_to_int(tab[j, w, c])
    return _pack(lambda j, w: coord(j, w, 1) - coord(j, w, 0),
                 lambda j, w: coord(j, w, 1) + coord(j, w, 0),
                 lambda j, w: coord(j, w, 3) * fe.D2)


_dev_cache: dict = {}


def fixed_base_tables(device) -> torch.Tensor:
    """own_tables() as a contiguous int32 tensor on `device` (cached)."""
    key = str(device)
    if key not in _dev_cache:
        _dev_cache[key] = torch.as_tensor(own_tables(),
                                          device=device).contiguous()
    return _dev_cache[key]
