"""gossvf: batched signature verification for gossip ingest on the
card (counterpart of the JAX package's gossip/gossvf.py).

The reference fronts its gossip tile with gossvf — a tile that
sigchecks inbound gossip traffic before the CRDS logic sees it
(ref: src/discof/gossip/ gossvf). Every gossip packet carries a LIST of
CRDS values (1 to 18 on the wire), and each packet is checked as one
batch through the port's kernels:

  * mode="individual": ops/cuda_ed.verify_batch, the SHA-512 kernel's
    in-place entry then the fused strict verify;
  * mode="bulk": ops/cuda_msm.rlc_verify_batch, SHA-512 and the two MSM
    stages checking the whole packet as one random-linear-combination
    equation at the reference's pinned RLC_LANES x RLC_WIDTH (pad lanes
    carry z = 0, which zeroes each of their terms). A passing batch
    accepts every prechecked lane under the COFACTORED semantics the
    kernel pins — sound for CRDS, where a torsion-malleated signature
    still needs the origin's OWN secret key, so no third party's value
    is ever falsely accepted. A failing batch, or a packet of more than
    RLC_LANES values, goes to the strict kernels as in mode="individual".

A tensor on the CPU runs the kernels' plain versions (as every wrapper
does), so `device="cpu"` gives the verdicts of the card without one.

The RLC coefficients z must stay secret from the senders. They come
from the `rng` the caller passes (a numpy Generator), by default one
generator per process seeded from os.urandom (the reference's module
global `_Z_RNG`); tests pass their own.

The reference's width rule stays: a value whose signable is longer than
MAX_SIGNABLE is verified on the host oracle (utils/ed25519_ref), with
the reference's verdict. No datagram can carry one (the gossip MTU is
1,232 bytes); a value built in process can.

Where the port differs from the reference: `warmup_bulk` raises
whatever the kernels raise, and the gossip tile lets it out of its
constructor (the reference's tile drops to individual-only, ROADMAP.md
C).
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import cuda_ed, cuda_msm
from ..utils.ed25519_ref import verify as host_verify

MAX_SIGNABLE = 1232            # gossip values ride single datagrams

# the bulk equation's ONE pinned shape (gossvf.py:46-47 of the
# reference): packets with more live values than RLC_LANES skip the
# filter and take the strict path
RLC_LANES = 32
RLC_WIDTH = -(-MAX_SIGNABLE // 64) * 64

_Z_RNG = np.random.default_rng(int.from_bytes(os.urandom(16), "little"))


def _bucket(n: int) -> int:
    return max(64, -(-n // 64) * 64)


def _rlc_batch_ok(sig, pub, msg, ln, rng,
                  device) -> tuple[bool, np.ndarray]:
    """One RLC batch equation over assembled lanes -> (batch_ok,
    lane_pre), padded to the pinned (RLC_LANES, RLC_WIDTH) shape.
    A packet of more than RLC_LANES values returns a failed batch, so
    the caller strict-verifies it."""
    n = sig.shape[0]
    if n > RLC_LANES:
        return False, np.zeros(n, bool)
    ps = np.zeros((RLC_LANES, 64), np.uint8)
    pp = np.zeros((RLC_LANES, 32), np.uint8)
    pm = np.zeros((RLC_LANES, RLC_WIDTH), np.uint8)
    pl = np.zeros(RLC_LANES, np.int32)
    ps[:n], pp[:n] = sig, pub
    pm[:n, :msg.shape[1]] = msg
    pl[:n] = ln
    z = np.zeros((RLC_LANES, 16), np.uint8)
    z[:n] = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    ok, lane_pre = cuda_msm.rlc_verify_batch(ps, pp, pm, pl, z, device)
    return bool(ok), lane_pre[:n].cpu().numpy()


def warmup_bulk(device="cuda"):
    """Run the bulk pre-filter once at its pinned shape, at the gossip
    tile's boot: a kernel that does not build or launch raises here."""
    _rlc_batch_ok(np.zeros((1, 64), np.uint8), np.zeros((1, 32), np.uint8),
                  np.zeros((1, 64), np.uint8), np.zeros(1, np.int32),
                  _Z_RNG, device)


def batch_verify(values, mode: str = "individual", device="cuda",
                 rng=None) -> list[bool]:
    """values: [CrdsValue] -> per-value signature verdicts, one batch
    for the packet on `device`; `rng` draws the RLC coefficients of
    mode="bulk" (default: the per-process generator)."""
    if not values:
        return []
    if mode not in ("individual", "bulk"):
        raise ValueError(f"unknown gossvf mode {mode!r}")
    msgs = [v.signable() for v in values]
    n = len(values)
    out: list[bool | None] = [None] * n
    width = _bucket(max((len(m) for m in msgs
                         if len(m) <= MAX_SIGNABLE), default=64))
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = np.zeros((n, width), np.uint8)
    ln = np.zeros((n,), np.int32)
    for i, (v, m) in enumerate(zip(values, msgs)):
        if len(v.signature) != 64 or len(v.origin) != 32:
            out[i] = False                # malformed
        elif len(m) > MAX_SIGNABLE:
            out[i] = bool(host_verify(v.signature, v.origin, m))
        else:
            sig[i] = np.frombuffer(v.signature, np.uint8)
            pub[i] = np.frombuffer(v.origin, np.uint8)
            msg[i, :len(m)] = np.frombuffer(m, np.uint8)
            ln[i] = len(m)
    if int(ln.max(initial=0)) > 0:
        if mode == "bulk":
            batch_ok, lane_pre = _rlc_batch_ok(
                sig, pub, msg, ln, _Z_RNG if rng is None else rng, device)
            if batch_ok:
                for i in range(n):
                    if out[i] is None:
                        out[i] = bool(lane_pre[i]) and int(ln[i]) > 0
                return [bool(o) for o in out]
            # the batch equation failed: strict-verify every lane below
        ok = cuda_ed.verify_batch(sig, pub, msg, ln, device).cpu().numpy()
        for i in range(n):
            if out[i] is None:
                out[i] = bool(ok[i]) and int(ln[i]) > 0
    return [bool(o) for o in out]
