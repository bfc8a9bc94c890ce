"""Proof-of-History hash chain: batched entry verification and host
generation (the port's counterpart of the JAX package's ops/poh.py:
`poh_verify_entries` (:41) on the SHA-256 kernel's `poh_verify` entry,
csrc/sha256.cu, with its plain version `poh_verify_plain`, and copies of
the host half, :74-142: `host_poh_append`, `host_poh_mixin`,
`host_poh_mixin_chain` and `PohChain`).

Reference semantics (ref: src/ballet/poh/fd_poh.c — fd_poh_append is n
repeated SHA-256's of the 32-byte state; fd_poh_mixin is one SHA-256
over state ‖ mixin):

  append(state, n):  state <- sha256^n(state)
  mixin(state, m):   state <- sha256(state ‖ m)

Generation is inherently sequential (that's the point of PoH), so the
poh tile generates on the host. Verification is parallel at entry
granularity: each entry declares (num_hashes, optional mixin), and its
chain segment is recomputed from its prev hash alone.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .. import device as _device

__all__ = ["poh_verify_entries", "poh_verify_plain", "host_poh_append",
           "host_poh_mixin", "host_poh_mixin_chain", "PohChain"]


def poh_verify_plain(prev, num_hashes, mixin, has_mixin, expected,
                     max_hashes: int) -> torch.Tensor:
    """The plain version of the kernel's `poh_verify`, step for step the
    reference's scan (ops/poh.py:41-71): every entry runs max_hashes
    steps, a step past its own n_plain (num_hashes - 1 with a mixin,
    num_hashes without) keeping its state, so an entry with more plain
    hashes than max_hashes gets max_hashes of them; then the mixin hash.
    prev, mixin, expected (N, 32) uint8, num_hashes (N,) int32, has_mixin
    (N,) bool -> (N,) bool, false wherever num_hashes < 1."""
    import torch

    from .sha2 import sha256
    state = prev
    n32 = torch.full(prev.shape[:-1], 32, dtype=torch.int32,
                     device=prev.device)
    n_plain = torch.where(has_mixin, num_hashes - 1, num_hashes)
    for i in range(max_hashes):
        state = torch.where((i < n_plain).unsqueeze(-1), sha256(state, n32),
                            state)
    mixed = sha256(torch.cat([state, mixin], dim=-1), n32 * 2)
    final = torch.where(has_mixin.unsqueeze(-1), mixed, state)
    return (final == expected).all(dim=-1) & (num_hashes >= 1)


def poh_verify_entries(prev_hash, num_hashes, mixin, has_mixin, expected,
                       max_hashes: int, device="cuda") -> torch.Tensor:
    """Batched PoH entry verification on `device`: the SHA-256 kernel's
    `poh_verify` on the card, its plain version on the CPU.

    prev_hash (N, 32) uint8 — chain state before the entry;
    num_hashes (N,) int32 — hashes in the entry (>= 1 to be valid);
    mixin (N, 32) uint8 — ignored where not has_mixin;
    has_mixin (N,) bool — tick entries have none;
    expected (N, 32) uint8 — the declared state after the entry;
    max_hashes — the bound on plain hashes an entry is given (consensus:
    hashes per tick). numpy arrays or tensors -> (N,) bool on `device`:
    num_hashes applications in all, the last absorbing the mixin."""
    import torch

    from .cuda_sha256 import poh_verify
    dev = _device.resolve(device)
    u8 = dict(dtype=torch.uint8, device=dev)
    return poh_verify(
        torch.as_tensor(prev_hash, **u8).contiguous(),
        torch.as_tensor(num_hashes, dtype=torch.int32, device=dev),
        torch.as_tensor(mixin, **u8).contiguous(),
        torch.as_tensor(has_mixin, dtype=torch.bool, device=dev),
        torch.as_tensor(expected, **u8).contiguous(), max_hashes)


# -- host-side generation (the poh tile's inner loop) ----------------------

def host_poh_append(state: bytes, n: int) -> bytes:
    for _ in range(n):
        state = hashlib.sha256(state).digest()
    return state


def host_poh_mixin(state: bytes, mixin: bytes) -> bytes:
    return hashlib.sha256(state + mixin).digest()


def host_poh_mixin_chain(state: bytes, mixins) -> list[bytes]:
    """One hash-chain call over a WAVE of mixins: returns the state
    after each mixin, byte-identical to folding host_poh_mixin
    sequentially (the chain is inherently ordered — this batches the
    Python call overhead, not the recurrence; tests pin the
    equivalence). The caller's state after the wave is the last
    element."""
    out = []
    for m in mixins:
        state = hashlib.sha256(state + m).digest()
        out.append(state)
    return out


class PohChain:
    """Host chain state + entry recorder (the poh tile's bookkeeping,
    ref: src/discof/poh/fd_poh.h:4-31)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.state = seed
        self.entries: list[dict] = []

    def tick(self, num_hashes: int):
        prev = self.state
        self.state = host_poh_append(self.state, num_hashes)
        self.entries.append({
            "prev": prev, "num_hashes": num_hashes,
            "mixin": None, "hash": self.state,
        })

    def record(self, mixin: bytes, num_hashes: int):
        """num_hashes total, the last absorbs the mixin."""
        assert num_hashes >= 1
        prev = self.state
        st = host_poh_append(self.state, num_hashes - 1)
        self.state = host_poh_mixin(st, mixin)
        self.entries.append({
            "prev": prev, "num_hashes": num_hashes,
            "mixin": mixin, "hash": self.state,
        })

    def entry_arrays(self, max_hashes: int):
        """Pack recorded entries into the inputs of poh_verify_entries."""
        n = len(self.entries)
        prev = np.zeros((n, 32), np.uint8)
        num = np.zeros((n,), np.int32)
        mix = np.zeros((n, 32), np.uint8)
        has = np.zeros((n,), bool)
        exp = np.zeros((n, 32), np.uint8)
        for i, e in enumerate(self.entries):
            assert e["num_hashes"] <= max_hashes
            prev[i] = np.frombuffer(e["prev"], np.uint8)
            num[i] = e["num_hashes"]
            if e["mixin"] is not None:
                mix[i] = np.frombuffer(e["mixin"], np.uint8)
                has[i] = True
            exp[i] = np.frombuffer(e["hash"], np.uint8)
        return prev, num, mix, has, exp
