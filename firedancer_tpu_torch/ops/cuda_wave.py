"""The bank's wave scan (csrc/wave_scan.cu; it replaces the jitted
`lax.scan` of firedancer_tpu/svm/executor.py `_scan_packed`, :111) and its
plain PyTorch version.

`wave_scan(packed, bal_hi, bal_lo) -> (bal_hi, bal_lo, status)`:
packed (W, C, 7) uint32 lanes (src, dst, amt_hi, amt_lo, fee_hi, fee_lo,
act), bal_hi / bal_lo (A,) uint32 halves of the u64 balances; returns the
balances after the W waves and the (W, C) int32 statuses (STATUS_PAD for
an inactive lane, else STATUS_OK, STATUS_INSUFFICIENT or STATUS_FEE_FAIL,
svm/executor.py). The lanes of one wave must be account-disjoint, as the
conflict DAG's waves are. `wave_scan_slab` returns the same results as
one int32 slab, [bal_hi | bal_lo | status], the one allocation a launch
makes; `split_slab` cuts it into the three views.

packed, bal_hi and bal_lo must be contiguous and 16-byte aligned (the
kernel stages them by bulk asynchronous copies), on either device. A CPU
tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the call raises. `launches` counts kernel launches and nothing else."""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import _build

STATUS_PAD = -1
STATUS_OK = 0
STATUS_INSUFFICIENT = 1
STATUS_FEE_FAIL = 2

launches = {"wave_scan": 0}
# exec shards polled on threads of one process (tools/exec_drills.py)
# launch at once; the count is a read-modify-write
_count_lock = threading.Lock()

_ARGS = [ct.c_void_p, ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p,
         ct.c_int] + [ct.c_void_p] * 5
_PLAN_ARGS = [ct.c_int] * 3 + [ct.c_void_p]
PLAN_KEYS = ("ring", "sbal", "slots", "chunks", "chunk_lanes",
             "scan_threads", "threads", "smem")
_MASK = (1 << 32) - 1


def _check(name, t, shape, dtype, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"wave_scan: {name} must be a contiguous {shape} "
                         f"{dtype} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"wave_scan: {name} must be 16-byte aligned, got "
                         f"address {t.data_ptr():#x}")


def _ge(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & (al >= bl))


def wave_scan_plain(packed, bal_hi, bal_lo):
    """The scan in int64 tensors, each u64 as two 32-bit halves with
    explicit carries and borrows (the reference's u64_add, u64_sub and
    u64_ge, executor.py:125-134), one step per wave."""
    p = packed.to(torch.int64)
    n_acct = bal_hi.shape[0]
    src, dst = p[..., 0], p[..., 1]
    amt_hi, amt_lo, fee_hi, fee_lo = p[..., 2], p[..., 3], p[..., 4], \
        p[..., 5]
    act = (p[..., 6] != 0) & (src < n_acct) & (dst < n_acct)
    lo = amt_lo + fee_lo
    need_lo = lo & _MASK
    need_hi = (amt_hi + fee_hi + (lo >> 32)) & _MASK
    bh = bal_hi.to(torch.int64).clone()
    bl = bal_lo.to(torch.int64).clone()
    status = torch.full(src.shape, STATUS_PAD, dtype=torch.int32,
                        device=packed.device)
    zero = torch.zeros((), dtype=torch.int64, device=packed.device)
    for w in range(p.shape[0]):
        a = act[w]
        s, d = src[w][a], dst[w][a]
        fh, fl = fee_hi[w][a], fee_lo[w][a]
        nh, nl = need_hi[w][a], need_lo[w][a]
        ah, al = amt_hi[w][a], amt_lo[w][a]
        s_hi, s_lo = bh[s], bl[s]
        fee_ok = _ge(s_hi, s_lo, fh, fl)
        ok = _ge(s_hi, s_lo, nh, nl)
        sub_hi = torch.where(ok, nh, torch.where(fee_ok, fh, zero))
        sub_lo = torch.where(ok, nl, torch.where(fee_ok, fl, zero))
        r_lo = s_lo - sub_lo
        bh[s] = (s_hi - sub_hi - (r_lo < 0).long()) & _MASK
        bl[s] = r_lo & _MASK
        d_hi, d_lo = bh[d], bl[d]            # after the src write
        r_lo = d_lo + torch.where(ok, al, zero)
        bh[d] = (d_hi + torch.where(ok, ah, zero) + (r_lo >> 32)) & _MASK
        bl[d] = r_lo & _MASK
        status[w][a] = torch.where(
            ok, STATUS_OK, torch.where(fee_ok, STATUS_INSUFFICIENT,
                                       STATUS_FEE_FAIL)).to(torch.int32)
    return bh.to(torch.uint32), bl.to(torch.uint32), status


def _checked(packed, bal_hi, bal_lo):
    """The inputs' checks -> (A, W, C)."""
    dev = packed.device
    if packed.dim() != 3 or packed.shape[2] != 7:
        raise ValueError(f"wave_scan: packed must be (W, C, 7), got "
                         f"{tuple(packed.shape)}")
    w, c = packed.shape[0], packed.shape[1]
    a = bal_hi.shape[0] if bal_hi.dim() == 1 else -1
    for name, t, shape, dtype in (("packed", packed, (w, c, 7), torch.uint32),
                                  ("bal_hi", bal_hi, (a,), torch.uint32),
                                  ("bal_lo", bal_lo, (a,), torch.uint32)):
        _check(name, t, shape, dtype, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wave_scan: tensors on {dev}; expected CUDA")
    if w * c >= 1 << 31:
        raise ValueError(f"wave_scan: {w} x {c} lanes; at most 2^31 - 1")
    return a, w, c


def plan(w: int, c: int, a: int, lib=None) -> dict:
    """The kernel's launch plan for W x C lanes over A accounts (csrc
    wave_plan): ring or resident table, balances in shared memory or not,
    slots, chunks, chunk lanes, threads and shared-memory bytes. `lib`: a
    loaded library of csrc/wave_scan.cu (default: the card's build)."""
    if lib is None:
        fn = _build.lib("wave_scan", _PLAN_ARGS, "fdtt_wave_plan")
    else:
        fn = lib.fdtt_wave_plan
        fn.argtypes = _PLAN_ARGS
    out = (ct.c_int64 * len(PLAN_KEYS))()
    fn(w, c, a, ct.addressof(out))
    return dict(zip(PLAN_KEYS, out))


def split_slab(slab, a: int, w: int, c: int):
    """[bal_hi | bal_lo | status] int32 slab -> (bal_hi, bal_lo (A,)
    uint32, status (W, C) int32) views."""
    return (slab[:a].view(torch.uint32), slab[a:2 * a].view(torch.uint32),
            slab[2 * a:2 * a + w * c].view(w, c))


def _launch(packed, bal_hi, bal_lo, a, w, c):
    """One allocation: the result slab, then, at an 8-byte boundary, A + 1
    64-bit words of scratch, which the kernel takes for the balances where
    they do not fit in shared memory. -> the result slab."""
    dev = packed.device
    fn = _build.lib("wave_scan", _ARGS)
    n = 2 * a + w * c
    at = (n + 1) & ~1
    buf = torch.empty(at + 2 * a + 2, dtype=torch.int32, device=dev)
    out = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = fn(packed.data_ptr(), w, c, bal_hi.data_ptr(),
                bal_lo.data_ptr(), a, out, out + 4 * a, out + 8 * a,
                out + 4 * at, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("wave_scan", rc)
    with _count_lock:
        launches["wave_scan"] += 1
    return buf[:n]


def wave_scan_slab(packed, bal_hi, bal_lo):
    """packed (W, C, 7) uint32, bal_hi, bal_lo (A,) uint32 -> (2 A + W C,)
    int32 slab [bal_hi | bal_lo | status] (`split_slab`)."""
    a, w, c = _checked(packed, bal_hi, bal_lo)
    if packed.device.type == "cpu":
        hi, lo, st = wave_scan_plain(packed, bal_hi, bal_lo)
        return torch.cat((hi.view(torch.int32), lo.view(torch.int32),
                          st.reshape(-1)))
    return _launch(packed, bal_hi, bal_lo, a, w, c)


def wave_scan(packed, bal_hi, bal_lo):
    """packed (W, C, 7) uint32, bal_hi, bal_lo (A,) uint32 -> (bal_hi,
    bal_lo (A,) uint32, status (W, C) int32)."""
    a, w, c = _checked(packed, bal_hi, bal_lo)
    if packed.device.type == "cpu":
        return wave_scan_plain(packed, bal_hi, bal_lo)
    return split_slab(_launch(packed, bal_hi, bal_lo, a, w, c), a, w, c)
