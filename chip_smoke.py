#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (firedancer_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source,
started together), holds each against its plain PyTorch version on the
card, runs every Wycheproof and malleability vector through the kernel
path, then drives the port's paths at bench.py's shape (8192 lanes x
1232-byte messages), each with the launch counts set to 0 just before it
and read just after:

  strict    phases 6-7: `verify_batch` (SHA-512's in-place entry
            `sha512_ram` with the prechecks, then the verify kernel), and
            the verify tile (synth -> shm ring -> VerifyTile(batch=2048)
            -> out ring);
  RLC       phase 8c: `rlc_verify_batch` on valid, forged, structurally
            masked and torsion batches (phases 8a-8b hold the two MSM
            kernels to their plain versions on every lane class, stage 2
            at 128, 32 and 79 blocks; 8d times them at 8192 and 2048
            lanes);
  flood     phase 9: the front door, VerifyTile(mode="bulk_prefilter",
            coalesce_us=150000) on forged-flood chunks, a mix with 256
            valid txns, and torsion forgeries.

Phase 3 holds both SHA-512 entries to their plain versions (3b: every
precheck class, at two row widths: the kernel's two copy paths);
phase 6a times them and the verify kernel, at 8192 and 2048 lanes; phase
2 prints ptxas's registers, stack and shared memory per entry point.
Any mismatch raises. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it a JSON object with each kernel's launches on the
paths, error against its plain version, time, plain time and bound.
Without a CUDA card it exits 2 and prints no result. No JAX is used.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192                 # bench.py kernel batch
MSG_LEN = 1232           # protocol MTU: bench.py msg_len
TILE_BATCH = 2048        # bench.py e2e tile batch
TILE_UNIQUE = 256
TILE_CORRUPT = 1024
TILE_FRAMES = 16384
FLOOD_CHUNKS = 4          # all-forged chunks of TILE_BATCH frames (phase 9)
FLOOD_MIX_FORGED = 248    # forged frames after the 256 valid ones
ITERS = 20
N_UNIQUE = 256          # distinct signatures behind the 8192 lanes
DEVICE = "cuda"

# Least-time model (see PERF.md "Port: PyTorch/CUDA on H100"): the H100
# SXM's INT32 rate, 132 SMs x 64 INT32 lanes x 1.98 GHz boost, and its
# HBM3 rate of 3.35 TB/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# SHA-512, 32-bit instructions per 128-byte block at the fewest the
# algorithm allows on this ISA: a round is Sigma1 + Sigma0 (3 funnel-
# shift rotates of a 64-bit word, 6 SHF, and one LOP3 xor3 per half:
# 8 each), ch and maj (one LOP3 per half: 2 each), t1 (a 5-term 64-bit
# sum, 4 IADD3), e = d + t1 and a = t1 + Sigma0 + maj (2 each) = 28; a
# schedule word is sigma0 + sigma1 (8 each) and a 4-term sum (4) = 20;
# the state update is 8 64-bit adds (16).
SHA_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16
# A field multiply is 100 32x32->64 products summed in int64: two INT32
# operations each. Adds, carries and table loads are not counted, so the
# bound stays below the true least time.
OPS_PER_FIELD_MUL = 200
# MSM stage 1's scalar work per lane, in int64 multiplies: sc_reduce64
# (14 folds of 6 and a final 6: 90) of k64, and sc_mul_mod_l of z k and
# z S (91 digit products and a sc_reduce64 each), counted at 4 INT32
# operations an int64 multiply.
SCALAR_OPS_PER_LANE = 4 * (90 + 2 * (91 + 90))
SMALL_B = TILE_BATCH     # the second timed size: the tile's chunk
RAGGED_B = 5000          # stage 2 at 79 blocks, the last chunk ragged


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, CUDA events around the run."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def signed_batch(n_unique: int, n: int, msg_len: int, seed: int):
    """n lanes tiled from n_unique RFC 8032 signatures over random
    msg_len-byte messages (the pure-Python signer is slow, so keys and
    messages repeat). -> sig (n,64), pub (n,32), msg (n,msg_len) uint8,
    msg_len (n,) int32."""
    from firedancer_tpu_torch.utils import ed25519_ref as ref
    rng = np.random.default_rng(seed)
    sig = np.zeros((n_unique, 64), np.uint8)
    pub = np.zeros((n_unique, 32), np.uint8)
    msg = rng.integers(0, 256, (n_unique, msg_len), np.uint8)
    for i in range(n_unique):
        key = rng.bytes(32)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, msg[i].tobytes()), np.uint8)
    idx = np.arange(n) % n_unique
    return (sig[idx].copy(), pub[idx].copy(), msg[idx].copy(),
            np.full(n, msg_len, np.int32))


def corrupt(sig, pub, msg):
    """Mixed verdict pattern by lane % 8: 0, 5 valid; 1 R, 2 S, 3 msg,
    4 A flipped; 6 S = l + 5 (>= l); 7 small-order A. -> expected strict
    verdicts (B,) bool."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    kind = np.arange(len(sig)) % 8
    sig[kind == 1, 0] ^= 1
    sig[kind == 2, 32] ^= 1
    msg[kind == 3, -1] ^= 0x80
    pub[kind == 4, 0] ^= 1
    sig[kind == 6, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                        np.uint8)
    pub[kind == 7] = ed._small_order_encodings()[1]
    return (kind == 0) | (kind == 5)


def k64_of(sig, pub, msg, ln):
    return np.stack([np.frombuffer(hashlib.sha512(
        sig[i, :32].tobytes() + pub[i].tobytes()
        + msg[i, :ln[i]].tobytes()).digest(), np.uint8)
        for i in range(len(sig))])


def count_field_muls(fn, *args):
    """(fn(*args), the field multiplies it performed): a plain version
    computes every product with fe25519.mul on (..., 10) limb tensors,
    and a kernel performs the same sequence, so the count is the number
    of limb rows multiplied."""
    from firedancer_tpu_torch.ops import fe25519 as fe
    count, mul = [0], fe.mul

    def counted(f, g):
        count[0] += int(np.prod(torch.broadcast_shapes(f.shape, g.shape)[:-1]))
        return mul(f, g)
    fe.mul = counted
    try:
        out = fn(*args)
    finally:
        fe.mul = mul
    return out, count[0]


def field_muls_per_verify() -> int:
    """Field multiplies of one verify, counted on the plain version over
    one lane on the CPU."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    sig, pub, msg, ln = signed_batch(1, 1, 32, 99)
    k64 = torch.from_numpy(k64_of(sig, pub, msg, ln))
    return count_field_muls(ed.verify_core, torch.from_numpy(sig),
                            torch.from_numpy(pub), k64,
                            fixed_base_tables("cpu"))[1]


def stats_of(ms, plain_ms, ops, nbytes) -> dict:
    """A kernel's time beside its bound: the larger of INT32 operations
    over the INT32 rate and bytes over the memory rate."""
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, bytes=nbytes, ops_ms=ops_ms, bytes_ms=bytes_ms)


def run_tile(frames, depth, **kw):
    """synth -> shm ring -> VerifyTile(**kw) -> out ring, in-process: the
    ring is pre-filled, then the tile polls until idle and flushes.
    -> (out-ring payloads, metrics, seconds of polling)."""
    from firedancer_tpu_torch.runtime import Ring, Tcache, Workspace
    from firedancer_tpu_torch.tiles.synth import SynthTile
    from firedancer_tpu_torch.tiles.verify import VerifyTile
    w = Workspace(f"/fdtt_smoke_{os.getpid()}", 1 << 26)
    try:
        in_ring = Ring.create(w, depth=depth, mtu=1280)
        out_ring = Ring.create(w, depth=1024, mtu=1280)
        tile = VerifyTile(in_ring, out_ring, Tcache(w, depth=4096),
                          batch=TILE_BATCH, device=DEVICE, **kw)
        SynthTile(in_ring, frames).run(len(frames))
        t0 = time.perf_counter()
        while tile.poll_once():
            pass
        tile.flush()
        sec = time.perf_counter() - t0
        out, seq = [], 0
        while True:
            rc, frag = out_ring.consume(seq)
            if rc != 0:
                break
            out.append(bytes(out_ring.payload(frag)))
            seq += 1
    finally:
        w.close()
        w.unlink()
    return out, dict(tile.metrics), sec


def load_vectors(root):
    """Every Wycheproof EdDSA vector and both malleability corpora
    (96-byte (sig, pub) records over "Zcash")."""
    vec = os.path.join(root, "tests", "vectors")
    recs = []
    with open(os.path.join(vec, "ed25519_wycheproof.json")) as f:
        for v in json.load(f):
            recs.append((bytes.fromhex(v["sig"]), bytes.fromhex(v["pub"]),
                         bytes.fromhex(v["msg"]), bool(v["ok"])))
    for name, expect in (("malleability_should_pass.bin", True),
                         ("malleability_should_fail.bin", False)):
        with open(os.path.join(vec, name), "rb") as f:
            raw = f.read()
        for off in range(0, len(raw), 96):
            recs.append((raw[off:off + 64], raw[off + 64:off + 96],
                         b"Zcash", expect))
    n, width = len(recs), max(len(r[2]) for r in recs)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = np.zeros((n, width), np.uint8)
    ln = np.zeros(n, np.int32)
    want = np.zeros(n, bool)
    for i, (s, p, m, ok) in enumerate(recs):
        sig[i], pub[i] = np.frombuffer(s, np.uint8), np.frombuffer(p, np.uint8)
        msg[i, :len(m)] = np.frombuffer(m, np.uint8)
        ln[i], want[i] = len(m), ok
    return sig, pub, msg, ln, want


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from firedancer_tpu_torch.ops import _build, cuda_ed, cuda_msm, cuda_sha
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import msm, sha2
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.utils.chaos import (
        attack_frames, torsion_sign, undecodable_point)

    def counts() -> dict:
        return {**cuda_sha.launches, "ed25519_verify": cuda_ed.launches,
                **cuda_msm.launches}

    def reset_counts():
        cuda_ed.launches = 0
        cuda_sha.launches.update(sha512=0, sha512_ram=0)
        cuda_msm.launches.update(msm_stage1=0, msm_stage2=0)

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    card = f"[{smi}]"

    # 1. device report
    log(f"== 1. device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build every kernel source (one nvcc per source, started together)
    log("== 2. build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"nvcc wall {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (sec, out) in sorted(built.items()):
        log(f"  {name}: {sec:.2f} s")
        for line in out.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "stack frame")):
                log(f"    {line.strip()}")

    # 3. SHA-512: kernel == plain == hashlib, R||A||M lengths 64..1296
    log("== 3. sha512 kernel vs plain vs hashlib")
    width = MSG_LEN + 64
    rng = np.random.default_rng(1)
    lens = rng.integers(64, width + 1, B).astype(np.int32)
    lens[:10] = [64, 111, 112, 127, 128, 239, 240, 255, 256, width]
    hmsg = rng.integers(0, 256, (B, width), np.uint8)
    hmsg[np.arange(width)[None, :] >= lens[:, None]] = 0
    m_d = torch.from_numpy(hmsg).to(dev)
    l_d = torch.from_numpy(lens).to(dev)
    got = cuda_sha.sha512(m_d, l_d)
    plain = sha2.sha512(m_d, l_d)
    torch.cuda.synchronize()
    sha_err = int((got.int() - plain.int()).abs().max())
    want = np.stack([np.frombuffer(hashlib.sha512(
        hmsg[i, :lens[i]].tobytes()).digest(), np.uint8) for i in range(B)])
    assert sha_err == 0, f"sha512 kernel != plain (max err {sha_err})"
    assert np.array_equal(got.cpu().numpy(), want), "sha512 != hashlib"
    log(f"sha512: {B} lanes, kernel == plain == hashlib, max_abs_err 0")

    # 3b. SHA-512's in-place entry: k64 and the prechecks, kernel == plain,
    # on every precheck class (lane % 8: 0 and 7 valid, 1 S = l - 1, 2 S =
    # l, 3 S = l + 5, 4 A.y >= p, 5 small-order A, 6 small-order R), at
    # the main path's row width (staged 16-byte pieces) and at an
    # unaligned one (each thread's own reads)
    log("== 3b. sha512_ram kernel vs plain (R||A||M in place, prechecks)")
    t0 = time.perf_counter()
    sig, pub, msg, ln = signed_batch(N_UNIQUE, B, MSG_LEN, 2)
    log(f"signed {N_UNIQUE} unique messages in "
        f"{time.perf_counter() - t0:.1f} s")
    pcls = np.arange(B) % 8
    psig, ppub = sig.copy(), pub.copy()
    for k, v in ((1, ed.L - 1), (2, ed.L), (3, ed.L + 5)):
        psig[pcls == k, 32:] = np.frombuffer(v.to_bytes(32, "little"),
                                             np.uint8)
    ppub[pcls == 4] = np.frombuffer(((1 << 255) - 1).to_bytes(32, "little"),
                                    np.uint8)
    ppub[pcls == 5] = ed._small_order_encodings()[3]
    psig[pcls == 6, :32] = ed._small_order_encodings()[6]
    want_pre = np.isin(pcls, (0, 1, 7)).astype(np.int32)
    ram_err = 0
    for w in (MSG_LEN, MSG_LEN - 3):
        plens = rng.integers(0, w + 1, B).astype(np.int32)
        plens[:8] = [0, 47, 48, 111, 112, 175, 176, w]
        pmsg = rng.integers(0, 256, (B, w), np.uint8)
        ins = [torch.from_numpy(x).to(dev) for x in (psig, ppub, pmsg, plens)]
        k_k, pre_k = cuda_sha.sha512_ram(*ins)
        k_p, pre_p = sha2.sha512_ram(*ins)
        torch.cuda.synchronize()
        err = max(int((k_k.int() - k_p.int()).abs().max()),
                  int((pre_k - pre_p).abs().max()))
        assert err == 0, f"sha512_ram kernel != plain at width {w}"
        assert np.array_equal(pre_k.cpu().numpy(), want_pre)
        for i in (0, 7, 8, B - 1):
            assert bytes(k_k[i].cpu().numpy()) == hashlib.sha512(
                psig[i, :32].tobytes() + ppub[i].tobytes()
                + pmsg[i, :plens[i]].tobytes()).digest()
        ram_err = max(ram_err, err)
        log(f"sha512_ram: {B} lanes, row width {w}, k64 and pre: kernel == "
            f"plain (hashlib on 4 lanes), prechecks pass on "
            f"{int(want_pre.sum())}, max_abs_err {err}")

    # 4. fused verify core: kernel == plain on mixed lanes, at 8192 (blocks
    # of 256 threads), at the tile's 2048 and at a ragged 2045 (blocks of
    # 128)
    log("== 4. ed25519_verify kernel vs plain (mixed verdicts)")
    msig, mpub, mmsg = sig.copy(), pub.copy(), msg.copy()
    expect = corrupt(msig, mpub, mmsg)
    k64 = k64_of(msig, mpub, mmsg, ln)
    s_d, p_d, k_d = (torch.from_numpy(x).to(dev) for x in (msig, mpub, k64))
    ver_err = 0
    for b in (B, SMALL_B, SMALL_B - 3):
        core = cuda_ed.verify_core(s_d[:b], p_d[:b], k_d[:b])
        core_plain = ed.verify_core(s_d[:b], p_d[:b], k_d[:b],
                                    fixed_base_tables(dev))
        torch.cuda.synchronize()
        err = int((core - core_plain).abs().max())
        assert err == 0, f"verify kernel != plain at {b} lanes on " \
            f"{int((core != core_plain).sum())} lanes"
        c = core.cpu().numpy()
        assert c.any() and not c.all()
        log(f"ed25519_verify: {b} lanes, kernel == plain (core passes "
            f"{int(c.sum())}), max_abs_err {err}")
        ver_err = max(ver_err, err)
    full = cuda_ed.verify_batch(msig, mpub, mmsg, ln,
                                device=DEVICE).cpu().numpy()
    assert np.array_equal(full, expect), \
        f"verify_batch != expected on {int((full != expect).sum())} lanes"
    log(f"verify_batch: {B} lanes == expected ({int(full.sum())} valid)")

    # 5. every Wycheproof and malleability vector through the kernels
    log("== 5. vectors")
    vs, vp, vm, vl, vwant = load_vectors(root)
    vgot = cuda_ed.verify_batch(vs, vp, vm, vl, device=DEVICE).cpu().numpy()
    bad = np.nonzero(vgot != vwant)[0]
    assert bad.size == 0, f"vectors: {bad.size} mismatches, first {bad[:10]}"
    log(f"vectors: {len(vwant)} of {len(vwant)} verdicts as the files "
        f"expect ({int(vwant.sum())} pass, {int((~vwant).sum())} fail)")

    # each kernel's own time at the main path's shape, the plain
    # version's, and the bound (launches here are not the main path's)
    log("== 6a. kernel times at the main path's shape " + card)
    hv = np.zeros((B, width), np.uint8)
    hv[:, :32], hv[:, 32:64], hv[:, 64:] = sig[:, :32], pub, msg
    hv_d = torch.from_numpy(hv).to(dev)
    hl_d = torch.full((B,), width, dtype=torch.int32, device=dev)
    vs_d, vp_d, vm_d, vl_d = (torch.from_numpy(x).to(dev)
                              for x in (sig, pub, msg, ln))
    vk_d = cuda_sha.sha512_ram(vs_d, vp_d, vm_d, vl_d)[0]
    stats = {}
    sha_blocks = int(sha2.nblocks(hl_d.long()).sum())
    muls = field_muls_per_verify()
    sv, pv, kv = vs_d[:SMALL_B], vp_d[:SMALL_B], vk_d[:SMALL_B]
    sm, sl = vm_d[:SMALL_B], vl_d[:SMALL_B]
    fb_bytes = fixed_base_tables(dev).numel() * 4
    # the in-place entry reads R, S, A and the message, writes k64 and pre
    ram_bytes = B * (64 + 32 + MSG_LEN + 4 + 64 + 4)
    for name, fn, pfn, iters, ops, nbytes in (
            ("sha512", lambda: cuda_sha.sha512(hv_d, hl_d),
             lambda: sha2.sha512(hv_d, hl_d), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK, B * (width + 4 + 64)),
            ("sha512_ram", lambda: cuda_sha.sha512_ram(vs_d, vp_d, vm_d, vl_d),
             lambda: sha2.sha512_ram(vs_d, vp_d, vm_d, vl_d), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK, ram_bytes),
            (f"sha512_ram@{SMALL_B}",
             lambda: cuda_sha.sha512_ram(sv, pv, sm, sl),
             lambda: sha2.sha512_ram(sv, pv, sm, sl), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK * SMALL_B // B,
             ram_bytes * SMALL_B // B),
            ("ed25519_verify", lambda: cuda_ed.verify_core(vs_d, vp_d, vk_d),
             lambda: ed.verify_core(vs_d, vp_d, vk_d, fixed_base_tables(dev)),
             ITERS, B * muls * OPS_PER_FIELD_MUL,
             B * (64 + 32 + 64 + 4) + fb_bytes),
            (f"ed25519_verify@{SMALL_B}",
             lambda: cuda_ed.verify_core(sv, pv, kv),
             lambda: ed.verify_core(sv, pv, kv, fixed_base_tables(dev)),
             ITERS, SMALL_B * muls * OPS_PER_FIELD_MUL,
             SMALL_B * (64 + 32 + 64 + 4) + fb_bytes)):
        st = stats[name] = stats_of(cuda_ms(fn, iters), cuda_ms(pfn, 1), ops,
                                    nbytes)
        log(f"{name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.2f} "
            f"ms, bound {st['bound_ms']:.4f} ms ({ops:.4g} int32 ops -> "
            f"{st['ops_ms']:.4f} ms, {nbytes} B -> {st['bytes_ms']:.4f} ms), "
            f"{st['ms'] / st['bound_ms']:.1f}x the bound {card}")
    log(f"field multiplies per verify: {muls}; sha512 blocks per batch: "
        f"{sha_blocks}")
    # is sha512_ram bound by the card's rate or by one lane's chain of
    # blocks? the same rows at 4 x the lanes (4 x the work), and the same
    # lanes with empty messages (one block each instead of 11)
    big = [x.repeat(4, *([1] * (x.dim() - 1))) for x in (vs_d, vp_d, vm_d,
                                                          vl_d)]
    empty = torch.zeros_like(vl_d)
    for label, args in ((f"{4 * B} lanes", big),
                        (f"{B} lanes, empty messages",
                         (vs_d, vp_d, vm_d, empty))):
        ms = cuda_ms(lambda: cuda_sha.sha512_ram(*args), ITERS)
        log(f"sha512_ram at {label}: {ms:.4f} ms (at {B} lanes, "
            f"{MSG_LEN}-byte messages: {stats['sha512_ram']['ms']:.4f} ms) "
            f"{card}")
    assert torch.equal(cuda_ed.verify_core(vs_d, vp_d, vk_d),
                       torch.ones(B, dtype=torch.int32, device=dev))

    # 6. strict path: verify_batch at 8192 x 1232, all valid
    reset_counts()
    log(f"== 6. strict path: verify_batch {B} x {MSG_LEN} {card}")
    ins = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, ln)]
    ok = cuda_ed.verify_batch(*ins, device=DEVICE)
    assert bool(ok.all()), f"{int((~ok).sum())} valid lanes rejected"
    ms = cuda_ms(lambda: cuda_ed.verify_batch(*ins, device=DEVICE),
                 ITERS)
    strict_ms = ms
    launches6 = counts()
    kern = stats["sha512_ram"]["ms"] + stats["ed25519_verify"]["ms"]
    log(f"verify_batch: {ms:.3f} ms per {B}-lane batch, "
        f"{B / ms * 1e3:.0f} verifies/s over {ITERS} iterations; the two "
        f"kernels {kern:.4f} ms, the rest (glue and launches) "
        f"{ms - kern:.4f} ms = {100 * (ms - kern) / ms:.1f}% {card}")

    # 7. the verify tile over real shm rings
    log(f"== 7. tile: synth -> ring -> VerifyTile(batch={TILE_BATCH}) -> ring")
    t0 = time.perf_counter()
    txns = make_signed_txns(TILE_UNIQUE, seed=7)
    frames = list(txns)
    for c in range(TILE_CORRUPT):              # distinct bad signatures
        bad = bytearray(txns[c % TILE_UNIQUE])
        bad[1 + 32 + c // TILE_UNIQUE] ^= 1    # S, so the tag is its own
        frames.append(bytes(bad))
    prng = np.random.default_rng(8)
    frames += [txns[i] for i in prng.integers(
        0, TILE_UNIQUE, TILE_FRAMES - len(frames))]
    frames = [frames[i] for i in prng.permutation(len(frames))]
    log(f"{len(frames)} frames ({TILE_UNIQUE} unique valid, {TILE_CORRUPT} "
        f"corrupt) built in {time.perf_counter() - t0:.1f} s")
    out, m, sec = run_tile(frames, TILE_FRAMES)
    log(f"tile metrics {json.dumps(m)}")
    log(f"tile: {len(frames)} frames in {sec:.3f} s, {len(frames) / sec:.0f} "
        f"frames/s, {m['batches']} device batches {card}")
    want_m = dict(rx=TILE_FRAMES, parse_fail=0, tx=TILE_UNIQUE,
                  verify_fail=TILE_CORRUPT,
                  dedup_drop=TILE_FRAMES - TILE_UNIQUE - TILE_CORRUPT)
    for key, val in want_m.items():
        assert m[key] == val, f"tile {key} = {m[key]}, expected {val}"
    assert sorted(out) == sorted(txns), "out ring != the unique valid txns"
    strict_path = counts()
    log(f"strict path launches: verify_batch phase {launches6}, with the "
        f"tile {strict_path}")
    assert launches6["sha512"] > 0 and launches6["ed25519_verify"] > 0
    assert strict_path["sha512"] > launches6["sha512"] and \
        strict_path["ed25519_verify"] > launches6["ed25519_verify"]

    # 8a. MSM stage 1, kernel vs plain, at 8192 lanes with every lane
    # class: valid, non-decodable R (lane % 64 == 1) and A (== 5), S >= l
    # (== 2), small-order A (== 3) and R (== 4), A.y >= p (== 7) and
    # R.y >= p (== 9) out of lane_ok; z = 0 (== 6) and z = 2^128 - 1
    # (== 8) kept
    log(f"== 8a. msm_stage1 kernel vs plain ({B} x {MSG_LEN}, every lane "
        f"class)")
    cls = np.arange(B) % 64
    csig, cpub = sig.copy(), pub.copy()
    p1 = np.frombuffer(((1 << 255) - 18).to_bytes(32, "little"), np.uint8)
    csig[cls == 1, :32] = undecodable_point(11)
    csig[cls == 2, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                        np.uint8)
    cpub[cls == 3] = ed._small_order_encodings()[1]
    csig[cls == 4, :32] = ed._small_order_encodings()[3]
    cpub[cls == 5] = undecodable_point(12)
    cpub[cls == 7] = p1
    csig[cls == 9, :32] = p1
    zb = np.random.default_rng(9).integers(0, 256, (B, 16), np.uint8)
    zb[cls == 6] = 0
    zb[cls == 8] = 0xFF
    captured = {}

    def recorded(key, fn):
        def f(*a):
            captured[key] = a
            return fn(*a)
        return f
    c_ins = [torch.from_numpy(x).to(dev) for x in (csig, cpub, msg, ln)]
    z_d = torch.from_numpy(zb).to(dev)
    ok, pre = ed.rlc_verify(*c_ins, z_d, cuda_sha.sha512_ram,
                            recorded("s1", cuda_msm.msm_stage1),
                            recorded("s2", cuda_msm.msm_stage2))
    want_pre = ~np.isin(cls, (1, 2, 3, 4, 5, 7, 9))
    assert bool(ok) and np.array_equal(pre.cpu().numpy(), want_pre), \
        "rlc verdict on the lane-class batch"
    got1 = cuda_msm.msm_stage1(*captured["s1"])
    want1 = msm.msm_stage1(*captured["s1"])
    torch.cuda.synchronize()
    s1_err = max(int((g.long() - w.long()).abs().max())
                 for g, w in zip(got1, want1))
    assert s1_err == 0, f"msm_stage1 kernel != plain (max err {s1_err})"
    log(f"msm_stage1: {B} lanes, {got1[0].shape[0]} blocks x 64 window "
        f"sums, kernel == plain in every limb, lane_ok and sdig equal, "
        f"max_abs_err 0")

    # 8b. MSM stage 2, kernel vs plain: the verdict and the sum's limbs,
    # for the batch's digit sums (it verifies) and with one digit raised
    # by 1 (it does not), over the lane-class batch's stage 1 at B = 8192
    # lanes (128 blocks: chunks of 12), SMALL_B = 2048 (32: chunks of 6)
    # and RAGGED_B = 5000 (79: chunks of 9, the last ragged)
    log("== 8b. msm_stage2 kernel vs plain (verdict and canonical sum)")
    tab = fixed_base_tables(dev)
    s2_err = 0
    for b in (B, SMALL_B, RAGGED_B):
        if b == B:
            wsum, sdig = captured["s2"]
        else:
            wsum, _, sdig = cuda_msm.msm_stage1(
                *(x[:b] for x in captured["s1"]))
        sdig_bad = sdig.clone()
        sdig_bad[0, 0] += 1
        for d_in, verdict in ((sdig, 1), (sdig_bad, 0)):
            ok_k, pt_k = cuda_msm.msm_stage2(wsum, d_in)
            ok_p, pt_p = msm.msm_stage2(wsum, d_in, tab)
            torch.cuda.synchronize()
            err = max(abs(int(ok_k) - int(ok_p)),
                      int((pt_k - pt_p).abs().max()))
            assert err == 0, f"msm_stage2 kernel != plain at {b} lanes"
            assert int(ok_k) == verdict, f"msm_stage2 verdict {int(ok_k)}"
            if verdict:                # the identity: X = 0, Y = Z
                assert not pt_k[0].any() and torch.equal(pt_k[1], pt_k[2])
            s2_err = max(s2_err, err)
        log(f"msm_stage2: {b} lanes ({wsum.shape[0]} blocks, chunks of "
            f"{msm.chunk_len(wsum.shape[0])}), verdicts 1 and 0 as "
            f"expected, kernel == plain (verdict and every canonical "
            f"limb), max_abs_err 0")

    # 8c. RLC path: rlc_verify_batch at 8192 x 1232 through the kernels,
    # each verdict equal to the plain version's on the card
    log(f"== 8c. RLC path: rlc_verify_batch {B} x {MSG_LEN} {card}")
    reset_counts()
    zv = np.random.default_rng(10).integers(0, 256, (B, 16), np.uint8)
    fmsg = msg.copy()
    fmsg[3, 0] ^= 1                    # lane 3's message forged
    ssig, spub = sig.copy(), pub.copy()
    ssig[10, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"),
                                  np.uint8)
    spub[20] = ed._small_order_encodings()[1]
    ssig[30, :32] = undecodable_point(13)
    tsig, tpub = sig.copy(), pub.copy()
    t_pub, t_sig = torsion_sign(b"\x33" * 32, msg[0].tobytes())
    tpub[0], tsig[0] = np.frombuffer(t_pub, np.uint8), \
        np.frombuffer(t_sig, np.uint8)
    z0, z1 = zv.copy(), zv.copy()
    z0[0, 0] &= 0xF8                   # z_0 = 0 mod 8
    z1[0, 0] |= 1                      # z_0 odd
    all_pre = np.ones(B, bool)
    cases = (("all valid", (sig, pub, msg), zv, True, all_pre),
             ("lane 3 forged", (sig, pub, fmsg), zv, False, all_pre),
             ("S >= l, small-order A, non-decodable R", (ssig, spub, msg),
              zv, True, ~np.isin(np.arange(B), (10, 20, 30))),
             ("torsion lane, z_0 = 0 mod 8", (tsig, tpub, msg), z0, True,
              all_pre),
             ("torsion lane, z_0 odd", (tsig, tpub, msg), z1, False, None))
    for label, (cs, cp, cm), cz, want_ok, want_pre in cases:
        c_in = [torch.from_numpy(x).to(dev) for x in (cs, cp, cm, ln, cz)]
        ok, pre = cuda_msm.rlc_verify_batch(*c_in, device=DEVICE)
        ok_p, pre_p = ed.rlc_verify_batch(*c_in, device=DEVICE)
        assert bool(ok) == bool(ok_p) == want_ok, f"rlc {label}: {bool(ok)}"
        assert torch.equal(pre, pre_p), f"rlc {label}: lane_pre != plain"
        if want_pre is not None:
            assert np.array_equal(pre.cpu().numpy(), want_pre), label
        log(f"rlc {label}: batch_ok {bool(ok)}, lane_pre false on "
            f"{int((~pre).sum())} lanes, kernels == plain")
    rlc_path = counts()
    log(f"RLC path launches {rlc_path}")
    assert min(rlc_path[k] for k in ("sha512", "msm_stage1",
                                     "msm_stage2")) > 0

    # 8d. each MSM kernel's own time at the RLC path's shape (all valid)
    # and at the tile's chunk, the plain version's, the bound; and the
    # whole rlc_verify_batch
    log(f"== 8d. MSM kernel times at {B} and {SMALL_B} lanes {card}")
    v_in = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, ln, zv)]
    sha_ms = stats["sha512_ram"]["ms"]
    ident = ed._identity(torch.zeros((1, 10), dtype=torch.int64))
    add_muls = count_field_muls(ed._add_full, ident, ident)[1]
    for b in (B, SMALL_B):
        ed.rlc_verify(*(x[:b] for x in v_in), cuda_sha.sha512_ram,
                      recorded("v1", cuda_msm.msm_stage1),
                      recorded("v2", cuda_msm.msm_stage2))
        nblk = -(-b // msm.LANES)
        wbytes = nblk * 64 * 160
        _, muls1 = count_field_muls(msm.msm_stage1, *captured["v1"])
        _, muls2 = count_field_muls(msm.msm_stage2, *captured["v2"], tab)
        # the plain version also adds, and drops, the steps of its last
        # chunk past the last block; the kernel's bound counts only the
        # adds the sums need
        S = msm.chunk_len(nblk)
        C = -(-nblk // S)
        muls2 -= (C * S - nblk) * 64 * add_muls
        sc_ops = b * SCALAR_OPS_PER_LANE
        tag = "" if b == B else f"@{b}"
        for name, fn, pfn, ops, nbytes in (
                ("msm_stage1", lambda: cuda_msm.msm_stage1(*captured["v1"]),
                 lambda: msm.msm_stage1(*captured["v1"]),
                 muls1 * OPS_PER_FIELD_MUL + sc_ops,
                 b * (32 + 64 + 64 + 16 + 4) + wbytes + nblk * 13 * 8),
                ("msm_stage2", lambda: cuda_msm.msm_stage2(*captured["v2"]),
                 lambda: msm.msm_stage2(*captured["v2"], tab),
                 muls2 * OPS_PER_FIELD_MUL,
                 wbytes + nblk * 13 * 8 + 64 * 120 + 41 * 4)):
            st = stats[name + tag] = stats_of(cuda_ms(fn, ITERS),
                                              cuda_ms(pfn, 1), ops, nbytes)
            log(f"{name}{tag}: kernel {st['ms']:.4f} ms, plain "
                f"{st['plain_ms']:.2f} ms, bound {st['bound_ms']:.4f} ms "
                f"({ops:.4g} int32 ops -> {st['ops_ms']:.4f} ms, {nbytes} "
                f"B -> {st['bytes_ms']:.4f} ms), "
                f"{st['ms'] / st['bound_ms']:.1f}x the bound {card}")
        log(f"{b} lanes: field multiplies stage 1 {muls1} ({muls1 / b:.1f} "
            f"per lane), stage 2 {muls2}; stage 1's scalar work {sc_ops} "
            f"int32 ops, {100 * sc_ops / (muls1 * OPS_PER_FIELD_MUL):.2f}% "
            f"of its field multiplies'; stage 2's chain: {S - 1} + {C - 1} "
            f"adds over {nblk} blocks (chunks of {S}), then 252 doublings "
            f"and 63 adds on a group (693 rounds), then one add")
    ms = cuda_ms(lambda: cuda_msm.rlc_verify_batch(*v_in, device=DEVICE),
                 ITERS)
    kern = sha_ms + stats["msm_stage1"]["ms"] + stats["msm_stage2"]["ms"]
    log(f"rlc_verify_batch: {ms:.3f} ms per {B}-lane batch, "
        f"{B / ms * 1e3:.0f} lanes/s over {ITERS} iterations; the three "
        f"kernels {kern:.4f} ms, the rest (glue and launches) "
        f"{ms - kern:.4f} ms = {100 * (ms - kern) / ms:.1f}%; strict "
        f"verify_batch (phase 6) {strict_ms:.3f} ms, "
        f"{B / strict_ms * 1e3:.0f} verifies/s {card}")

    # 9. the flood front door: the verify tile in bulk_prefilter mode with
    # the coalescing window of cfg/flood-demo.toml
    log(f"== 9. tile: synth -> ring -> VerifyTile(batch={TILE_BATCH}, "
        f"mode=bulk_prefilter, coalesce_us=150000) -> ring")
    t0 = time.perf_counter()
    pool = attack_frames("flood_forged", 8, seed=3)

    def forged(k):
        # a forged pool frame made unique: bytes 8..11 of S carry k, so
        # every frame has its own dedup tag and its own device lane
        f = bytearray(pool[k % len(pool)])
        f[1 + 40:1 + 44] = k.to_bytes(4, "little")
        return bytes(f)
    n_flood = FLOOD_CHUNKS * TILE_BATCH
    torsion = attack_frames("flood_torsion", 8, seed=21)
    assert len(set(torsion)) == 8
    frames = [forged(k) for k in range(n_flood)] + list(txns) \
        + [forged(n_flood + k) for k in range(FLOOD_MIX_FORGED)] + torsion
    log(f"{len(frames)} frames ({n_flood} forged in {FLOOD_CHUNKS} full "
        f"chunks, then {TILE_UNIQUE} valid, {FLOOD_MIX_FORGED} forged, 8 "
        f"torsion) built in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    out, m, sec = run_tile(frames, 16384, mode="bulk_prefilter",
                           coalesce_us=150000)
    flood_path = counts()
    log(f"tile metrics {json.dumps(m)}")
    log(f"flood tile: {len(frames)} frames in {sec:.3f} s, "
        f"{len(frames) / sec:.0f} frames/s, {m['rlc_batches']} RLC "
        f"equations ({m['rlc_ns'] / 1e6:.1f} ms), {m['batches']} strict "
        f"batches {card}")
    want_m = dict(rx=len(frames), parse_fail=0, dedup_drop=0, tx=TILE_UNIQUE,
                  rlc_shed=n_flood,
                  verify_fail=n_flood + FLOOD_MIX_FORGED + 8)
    for key, val in want_m.items():
        assert m[key] == val, f"flood tile {key} = {m[key]}, expected {val}"
    assert sorted(out) == sorted(txns), "out ring != the unique valid txns"
    assert not set(out) & set(torsion), "a torsion forgery was forwarded"
    log(f"flood path launches {flood_path}")
    assert min(flood_path.values()) > 0

    kernels = []
    paths = (strict_path, rlc_path, flood_path)
    for name, src, rep, err in (
            ("sha512", "firedancer_tpu_torch/csrc/sha512.cu",
             "firedancer_tpu/ops/pallas_sha.py:35", max(sha_err, ram_err)),
            ("sha512_ram", "firedancer_tpu_torch/csrc/sha512.cu",
             "firedancer_tpu/ops/pallas_sha.py:35", ram_err),
            ("ed25519_verify", "firedancer_tpu_torch/csrc/ed25519_verify.cu",
             "firedancer_tpu/ops/pallas_ed.py:634", ver_err),
            ("msm_stage1", "firedancer_tpu_torch/csrc/ed25519_msm.cu",
             "firedancer_tpu/ops/pallas_msm.py:136", s1_err),
            ("msm_stage2", "firedancer_tpu_torch/csrc/ed25519_msm.cu",
             "firedancer_tpu/ops/pallas_msm.py:210", s2_err)):
        st = stats[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": sum(p[name] for p in paths),
                        "max_abs_err": err,
                        "ms": st["ms"], "plain_ms": st["plain_ms"],
                        "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": None})
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
