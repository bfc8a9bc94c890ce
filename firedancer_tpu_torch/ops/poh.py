"""Proof-of-History hash chain, host generation (the port's copy of the
host half of the JAX package's ops/poh.py:74-142: `host_poh_append`,
`host_poh_mixin`, `host_poh_mixin_chain` and `PohChain`; the batched
entry verification `poh_verify_entries` (:41) and the sha256 it runs
come with the device ops, ROADMAP.md queue A item 4).

Reference semantics (ref: src/ballet/poh/fd_poh.c — fd_poh_append is n
repeated SHA-256's of the 32-byte state; fd_poh_mixin is one SHA-256
over state ‖ mixin):

  append(state, n):  state <- sha256^n(state)
  mixin(state, m):   state <- sha256(state ‖ m)

Generation is inherently sequential (that's the point of PoH), so the
poh tile generates on the host.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["host_poh_append", "host_poh_mixin", "host_poh_mixin_chain",
           "PohChain"]


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
        """Pack recorded entries into the inputs of poh_verify_entries
        (ROADMAP.md queue A item 4)."""
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
