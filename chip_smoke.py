#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (firedancer_tpu_torch) on one card.

    python3 chip_smoke.py

Builds both CUDA kernels from csrc/ with nvcc, holds each against its
plain PyTorch version on the card, runs every Wycheproof and
malleability vector through the kernel path, then drives the main path:
strict ed25519 `verify_batch` at bench.py's shape (8192 lanes x 1232-byte
messages) and the verify tile (synth -> shm ring -> VerifyTile(batch=2048)
-> out ring). Any mismatch raises. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it a JSON object with each kernel's launches on the
main path, error against its plain version, time, plain time and bound.
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


def field_muls_per_verify() -> int:
    """Field multiplies of one verify, counted on the plain version (the
    kernel performs the same sequence) over one lane on the CPU."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import fe25519 as fe
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    sig, pub, msg, ln = signed_batch(1, 1, 32, 99)
    k64 = torch.from_numpy(k64_of(sig, pub, msg, ln))
    count, mul = [0], fe.mul

    def counted(f, g):
        count[0] += 1
        return mul(f, g)
    fe.mul = counted
    try:
        ed.verify_core(torch.from_numpy(sig), torch.from_numpy(pub), k64,
                       fixed_base_tables("cpu"))
    finally:
        fe.mul = mul
    return count[0]


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
    from firedancer_tpu_torch.ops import _build, cuda_ed, cuda_sha
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import sha2
    from firedancer_tpu_torch.ops.params import fixed_base_tables
    from firedancer_tpu_torch.runtime import Ring, Tcache, Workspace
    from firedancer_tpu_torch.tiles.synth import SynthTile, make_signed_txns
    from firedancer_tpu_torch.tiles.verify import VerifyTile

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    card = f"[{smi}]"

    # 1. device report
    log(f"== 1. device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build both kernels (one nvcc per source, started together)
    log("== 2. build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"nvcc wall {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (sec, out) in sorted(built.items()):
        log(f"  {name}: {sec:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
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

    # 4. fused verify core: kernel == plain on 8192 mixed lanes
    log("== 4. ed25519_verify kernel vs plain (mixed verdicts)")
    t0 = time.perf_counter()
    sig, pub, msg, ln = signed_batch(N_UNIQUE, B, MSG_LEN, 2)
    log(f"signed {N_UNIQUE} unique messages in "
        f"{time.perf_counter() - t0:.1f} s")
    msig, mpub, mmsg = sig.copy(), pub.copy(), msg.copy()
    expect = corrupt(msig, mpub, mmsg)
    k64 = k64_of(msig, mpub, mmsg, ln)
    s_d, p_d, k_d = (torch.from_numpy(x).to(dev) for x in (msig, mpub, k64))
    core = cuda_ed.verify_core(s_d, p_d, k_d)
    core_plain = ed.verify_core(s_d, p_d, k_d, fixed_base_tables(dev))
    torch.cuda.synchronize()
    ver_err = int((core - core_plain).abs().max())
    assert ver_err == 0, f"verify kernel != plain on " \
        f"{int((core != core_plain).sum())} lanes"
    c = core.cpu().numpy()
    assert c.any() and not c.all()
    full = cuda_ed.verify_batch(msig, mpub, mmsg, ln,
                                device=DEVICE).cpu().numpy()
    assert np.array_equal(full, expect), \
        f"verify_batch != expected on {int((full != expect).sum())} lanes"
    log(f"ed25519_verify: {B} lanes, kernel == plain (core passes "
        f"{int(c.sum())}), verify_batch == expected ({int(full.sum())} "
        f"valid), max_abs_err 0")

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
    vs_d, vp_d = torch.from_numpy(sig).to(dev), torch.from_numpy(pub).to(dev)
    vk_d = cuda_sha.sha512(hv_d, hl_d)
    stats = {}
    sha_blocks = int(sha2.nblocks(hl_d.long()).sum())
    muls = field_muls_per_verify()
    for name, fn, pfn, iters, ops, nbytes in (
            ("sha512", lambda: cuda_sha.sha512(hv_d, hl_d),
             lambda: sha2.sha512(hv_d, hl_d), ITERS,
             sha_blocks * SHA_OPS_PER_BLOCK, B * (width + 4 + 64)),
            ("ed25519_verify", lambda: cuda_ed.verify_core(vs_d, vp_d, vk_d),
             lambda: ed.verify_core(vs_d, vp_d, vk_d, fixed_base_tables(dev)),
             ITERS, B * muls * OPS_PER_FIELD_MUL,
             B * (64 + 32 + 64 + 4) + fixed_base_tables(dev).numel() * 4)):
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(pfn, 1)
        ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, \
            nbytes / BYTES_PER_S * 1e3
        stats[name] = dict(ms=ms, plain_ms=plain_ms,
                           bound_ms=max(ops_ms, bytes_ms),
                           bound_by="operations" if ops_ms >= bytes_ms
                           else "bytes", ops=ops, bytes=nbytes)
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({ops:.4g} int32 ops -> "
            f"{ops_ms:.4f} ms, {nbytes} B -> {bytes_ms:.4f} ms), "
            f"{ms / max(ops_ms, bytes_ms):.1f}x the bound {card}")
    log(f"field multiplies per verify: {muls}; sha512 blocks per batch: "
        f"{sha_blocks}")
    assert torch.equal(cuda_ed.verify_core(vs_d, vp_d, vk_d),
                       torch.ones(B, dtype=torch.int32, device=dev))

    # 6. main path: verify_batch at 8192 x 1232, all valid
    cuda_sha.launches = cuda_ed.launches = 0
    log("== 6. main path: verify_batch 8192 x 1232 " + card)
    ins = [torch.from_numpy(x).to(dev) for x in (sig, pub, msg, ln)]
    ok = cuda_ed.verify_batch(*ins, device=DEVICE)
    assert bool(ok.all()), f"{int((~ok).sum())} valid lanes rejected"
    ms = cuda_ms(lambda: cuda_ed.verify_batch(*ins, device=DEVICE),
                 ITERS)
    launches6 = (cuda_sha.launches, cuda_ed.launches)
    log(f"verify_batch: {ms:.3f} ms per {B}-lane batch, "
        f"{B / ms * 1e3:.0f} verifies/s over {ITERS} iterations {card}")

    # 7. the verify tile over real shm rings
    log("== 7. tile: synth -> ring -> VerifyTile(batch=2048) -> ring")
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
    w = Workspace(f"/fdtt_smoke_{os.getpid()}", 1 << 26)
    try:
        in_ring = Ring.create(w, depth=TILE_FRAMES, mtu=1280)
        out_ring = Ring.create(w, depth=1024, mtu=1280)
        tile = VerifyTile(in_ring, out_ring, Tcache(w, depth=4096),
                          batch=TILE_BATCH, device=DEVICE)
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
    m = tile.metrics
    log(f"tile metrics {json.dumps(m)}")
    log(f"tile: {len(frames)} frames in {sec:.3f} s, {len(frames) / sec:.0f} "
        f"frames/s, {m['batches']} device batches {card}")
    want_m = dict(rx=TILE_FRAMES, parse_fail=0, tx=TILE_UNIQUE,
                  verify_fail=TILE_CORRUPT,
                  dedup_drop=TILE_FRAMES - TILE_UNIQUE - TILE_CORRUPT)
    for key, val in want_m.items():
        assert m[key] == val, f"tile {key} = {m[key]}, expected {val}"
    assert sorted(out) == sorted(txns), "out ring != the unique valid txns"
    launches = (cuda_sha.launches, cuda_ed.launches)
    log(f"launches: verify_batch phase {launches6}, with the tile "
        f"{launches} (sha512, ed25519_verify)")
    assert min(launches6) > 0 and min(launches[0] - launches6[0],
                                      launches[1] - launches6[1]) > 0

    kernels = []
    for name, src, rep, n, err in (
            ("sha512", "firedancer_tpu_torch/csrc/sha512.cu",
             "firedancer_tpu/ops/pallas_sha.py:35", launches[0], sha_err),
            ("ed25519_verify", "firedancer_tpu_torch/csrc/ed25519_verify.cu",
             "firedancer_tpu/ops/pallas_ed.py:634", launches[1], ver_err)):
        st = stats[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n, "max_abs_err": err,
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
