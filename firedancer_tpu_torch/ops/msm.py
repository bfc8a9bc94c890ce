"""Plain PyTorch versions of the two RLC MSM kernels (csrc/ed25519_msm.cu;
they replace firedancer_tpu/ops/pallas_msm.py `_msm_stage1_kernel` and
`_msm_stage2_kernel`, and the scalar glue around them).

Each function performs the kernel's limb operations in the kernel's
order, on int64 tensors, so a kernel is held to it exactly, window sums
included (no comparison falls back to canonical affine points):

  msm_stage1   per lane: the prechecks, k = k64 mod l, z k and z S mod l,
               decompression of A and R, tables of w(-A) (extended) and
               w(-R) (precomputed), one add per window; then per block of
               LANES lanes and per window, CHUNK lanes summed one after
               another in each of LANES / CHUNK chunks, and the chunks'
               sums one after another; and per block the column sums of
               z S's 21-bit digits over the lane_ok lanes.
  msm_stage2   each window summed over the nblk blocks in C chunks of
               S = chunk_len(nblk) consecutive blocks (the least S with
               S^2 >= nblk, C = ceil(nblk / S)): each chunk in block
               order, then the C chunk sums in chunk order; the Horner
               over the 64 window sums; s from the digit sums; the
               doubling-free fixed-base sum of [s]B; one add and the
               identity test.

The kernel runs a lane's point arithmetic on a group of four threads,
one field multiply each per round; a group performs the same field
operations as one thread, so the plain version is written per lane. A
point is four (..., 10) limb tensors (X, Y, Z, T); the stage outputs
stack them as (..., 4, 10) int32, the kernels' layout.
"""
from __future__ import annotations

import math

import torch

from . import ed25519 as ed
from . import fe25519 as fe

LANES = 64          # lanes per stage-1 block (MSM_L in the kernel)
CHUNK = 8           # lanes per chunk of a window's first sum (MSM_S)


def _stack(p) -> torch.Tensor:
    return torch.stack(p, dim=-2)


def lane_part(pub, sig, k64, z):
    """Stage 1's per-lane part. pub (B, 32), sig (B, 64), k64 (B, 64),
    z (B, 16) uint8 -> dict: contrib (B, 64, 4, 10) int64 (window j's
    contribution [zk_j](-A) + [z_j](-R), the identity where ok is
    False); k, zk, zs (B, 32) uint8 (k64 mod l, z k and z S mod l); pre,
    a_ok, r_ok, ok (B,) bool (prechecks, decompression of A and of R,
    lane_ok)."""
    pre = ed.rlc_prechecks(sig, pub)
    k = ed.sc_reduce64(k64)
    zk = ed.sc_mul_mod_l(k, z)
    zs = ed.sc_mul_mod_l(sig[:, 32:], z)
    ax, ay, at, a_ok = ed._decode_xyt(pub)
    rx, ry, rt, r_ok = ed._decode_xyt(sig[:, :32])
    ok = pre & a_ok & r_ok
    tab_a = torch.stack([_stack(p) for p in ed._neg_table(ax, ay, at)], 1)
    tab_r = torch.stack([_stack(p) for p in
                         ed._pre_table(ed._neg_table(rx, ry, rt))], 1)
    kw = ed.sc_windows4(zk)                              # (B, 64)
    zw = ed.sc_windows4(z)                               # (B, 32)
    zw = torch.cat([zw, torch.zeros_like(zw)], dim=-1)   # windows 32..63
    lanes = torch.arange(pub.shape[0], device=pub.device)[:, None]
    c = ed._add_pre(tab_a[lanes, kw].unbind(-2), tab_r[lanes, zw].unbind(-2))
    ident = ed._identity(c[0])
    keep = ok[:, None, None]
    c = tuple(torch.where(keep, x, i) for x, i in zip(c, ident))
    return dict(contrib=_stack(c), k=k, zk=zk, zs=zs, pre=pre, a_ok=a_ok,
                r_ok=r_ok, ok=ok)


def msm_stage1(pub, sig, k64, z):
    """-> (wsum (ceil(B / LANES), 64, 4, 10) int32 per-block window sums,
    lane_ok (B,) int32, sdig (ceil(B / LANES), 13) int64 per-block
    column sums of z S's 21-bit digits over the lane_ok lanes). The
    ragged last block is filled with identities and zero digits, as the
    kernel's idle groups contribute."""
    lp = lane_part(pub, sig, k64, z)
    c, ok = lp["contrib"], lp["ok"]
    zs = torch.where(ok[:, None], lp["zs"], 0)
    b = c.shape[0]
    nblk = -(-b // LANES)
    if nblk * LANES > b:
        ident = _stack(ed._identity(c[:1, :, 0]))        # (1, 64, 4, 10)
        c = torch.cat([c, ident.expand(nblk * LANES - b, -1, -1, -1)])
        zs = torch.cat([zs, zs.new_zeros(nblk * LANES - b, 32)])
    x = c.view(nblk, LANES // CHUNK, CHUNK, 64, 4, fe.NLIMB)
    acc = x[:, :, 0].unbind(-2)
    for i in range(1, CHUNK):                 # each chunk, lane by lane
        acc = ed._add_full(acc, x[:, :, i].unbind(-2))
    acc = _stack(acc)                         # (nblk, chunks, 64, 4, 10)
    tot = acc[:, 0].unbind(-2)
    for k in range(1, LANES // CHUNK):        # the chunks, one by one
        tot = ed._add_full(tot, acc[:, k].unbind(-2))
    sdig = ed.sc_digit_sums(zs.view(nblk, LANES, 32), dim=1)
    return _stack(tot).to(torch.int32), ok.to(torch.int32), sdig


def chunk_len(nblk: int) -> int:
    """Blocks a chunk of stage 2's sums over blocks: the least S with
    S * S >= nblk (msm_chunk in the kernel)."""
    return math.isqrt(nblk - 1) + 1


def window_totals(wsum: torch.Tensor):
    """(nblk, 64, 4, 10) int64 -> the 64 window totals as 4 x (64, 10):
    chunks of chunk_len(nblk) blocks, each in block order, then the
    chunk sums in chunk order."""
    nblk = wsum.shape[0]
    s = chunk_len(nblk)
    c = -(-nblk // s)
    idx = torch.arange(c * s, device=wsum.device).clamp(max=nblk - 1)
    x = wsum[idx].view(c, s, 64, 4, fe.NLIMB)
    acc = x[:, 0].unbind(-2)                       # 4 x (C, 64, 10)
    first = torch.arange(c, device=wsum.device)[:, None, None] * s
    for i in range(1, s):                          # every chunk at once
        nxt = ed._add_full(acc, x[:, i].unbind(-2))
        acc = tuple(torch.where(first + i < nblk, n, a)
                    for n, a in zip(nxt, acc))
    tot = tuple(a[0] for a in acc)
    for k in range(1, c):                          # the chunk sums
        tot = ed._add_full(tot, tuple(a[k] for a in acc))
    return tot


def msm_stage2(wsum, sdig, fb_tab):
    """wsum (nblk, 64, 4, 10) int32, sdig (nblk, 13) int64, fb_tab
    (64, 16, 3, 10) int32 (ops/params.py) -> (ok () int32, point (4, 10)
    int32: canonical limbs of sum_j 16^j W_j + [s]B, the identity when
    the batch verifies; s = the digit sums over the blocks, mod l)."""
    win = _stack(window_totals(wsum.to(torch.int64)))   # (64, 4, 10)

    h = win[63:].unbind(-2)                              # 4 x (1, 10)
    for j in range(62, -1, -1):
        h = ed._dbl(ed._dbl(ed._dbl(h, False), False), False)
        h = ed._dbl(h, True)
        h = ed._add_full(h, win[j:j + 1].unbind(-2))

    tab = fb_tab.to(torch.int64)
    sw = ed.sc_windows4(ed.sc_reduce_digits(sdig.sum(0)))
    f = ed._identity(h[0])
    for j in range(64):
        f = ed._madd_aff(f, tab[j, sw[j]][None].unbind(-2))

    h = ed._add_full(h, f)
    ok = fe.is_zero(h[0]) & fe.is_zero(fe.sub(h[1], h[2]))
    point = torch.stack([fe.canon(c)[0] for c in h])
    return ok[0].to(torch.int32), point.to(torch.int32)
