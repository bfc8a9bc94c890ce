"""Plain PyTorch versions of the two RLC MSM kernels (csrc/ed25519_msm.cu;
they replace firedancer_tpu/ops/pallas_msm.py `_msm_stage1_kernel` and
`_msm_stage2_kernel`).

Each function performs the kernel's limb operations in the kernel's
order, on int64 tensors, so a kernel is held to it exactly:

  msm_stage1   per lane: decompress A and R, tables of w(-A) (extended)
               and w(-R) (precomputed), one add per window; then per
               block of LANES lanes, the shared-memory tree that sums
               each window (level s: entry i += entry i + s, i < s).
  msm_stage2   each window summed over the blocks in block order; the
               Horner over the 64 window sums; the doubling-free
               fixed-base sum of [s]B; one add and the identity test.

A point is four (..., 10) limb tensors (X, Y, Z, T); the stage outputs
stack them as (..., 4, 10) int32, the kernels' layout.
"""
from __future__ import annotations

import torch

from . import ed25519 as ed
from . import fe25519 as fe

LANES = 64          # lanes per stage-1 block (MSM_T in the kernel)


def _stack(p) -> torch.Tensor:
    return torch.stack(p, dim=-2)


def lane_contributions(pub, sig, zk, z, mask):
    """Stage 1's per-lane part. pub (B, 32), sig (B, 64), zk (B, 32),
    z (B, 16) uint8, mask (B,) int32 -> (contrib (B, 64, 4, 10) int64,
    a_ok, r_ok, ok (B,) bool). Window j's contribution is
    [zk_j](-A) + [z_j](-R), the identity where ok is False."""
    ax, ay, at, a_ok = ed._decode_xyt(pub)
    rx, ry, rt, r_ok = ed._decode_xyt(sig[:, :32])
    ok = (mask != 0) & a_ok & r_ok
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
    return _stack(c), a_ok, r_ok, ok


def msm_stage1(pub, sig, zk, z, mask):
    """-> (wsum (ceil(B / LANES), 64, 4, 10) int32 per-block window sums,
    lane_ok (B,) int32). The ragged last block is filled with
    identities, as the kernel's idle threads contribute."""
    c, _, _, ok = lane_contributions(pub, sig, zk, z, mask)
    b = c.shape[0]
    nblk = -(-b // LANES)
    if nblk * LANES > b:
        ident = _stack(ed._identity(c[:1, :, 0]))        # (1, 64, 4, 10)
        c = torch.cat([c, ident.expand(nblk * LANES - b, -1, -1, -1)])
    x = c.view(nblk, LANES, 64, 4, fe.NLIMB)
    s = LANES // 2
    while s:
        x = _stack(ed._add_full(x[:, :s].unbind(-2), x[:, s:2 * s].unbind(-2)))
        s //= 2
    return x[:, 0].to(torch.int32), ok.to(torch.int32)


def msm_stage2(wsum, s_sum, fb_tab):
    """wsum (nblk, 64, 4, 10) int32, s_sum (32,) uint8, fb_tab
    (64, 16, 3, 10) int32 (ops/params.py) -> (ok () int32, point (4, 10)
    int32: canonical limbs of sum_j 16^j W_j + [s]B, the identity when
    the batch verifies)."""
    w = wsum.to(torch.int64)
    acc = w[0].unbind(-2)                                # 4 x (64, 10)
    for g in range(1, w.shape[0]):
        acc = ed._add_full(acc, w[g].unbind(-2))
    win = _stack(acc)                                    # (64, 4, 10)

    h = win[63:].unbind(-2)                              # 4 x (1, 10)
    for j in range(62, -1, -1):
        h = ed._dbl(ed._dbl(ed._dbl(h, False), False), False)
        h = ed._dbl(h, True)
        h = ed._add_full(h, win[j:j + 1].unbind(-2))

    tab = fb_tab.to(torch.int64)
    sw = ed.sc_windows4(s_sum)
    f = ed._identity(h[0])
    for j in range(64):
        f = ed._madd_aff(f, tab[j, sw[j]][None].unbind(-2))

    h = ed._add_full(h, f)
    ok = fe.is_zero(h[0]) & fe.is_zero(fe.sub(h[1], h[2]))
    point = torch.stack([fe.canon(c)[0] for c in h])
    return ok[0].to(torch.int32), point.to(torch.int32)
