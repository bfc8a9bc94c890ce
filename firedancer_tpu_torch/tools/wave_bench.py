"""The wave-scan kernel (csrc/wave_scan.cu) at the shapes of chip_smoke.py
phase 11, each held against its plain version and timed on the card.

    python firedancer_tpu_torch/tools/wave_bench.py [--root DIR] \\
        [--iters 20]

The shapes (`shapes`): bank0's wave at bench.py's shape (8 microblocks x
31 synth transfers from 16 signers); the wave the bank launches in the
leader topology (4 microblocks x 12); a random block of 4096 transfers
over 768 accounts with u64 edge values (a table past shared memory);
16,384 transfers over 40,000 accounts (balances past shared memory); and
bank0's table with every lane inactive (the bare chain of waits and
barriers). For each, `run_shape` checks every balance and status against
the plain version, then times the kernel on the device (a CUDA graph of
`iters` launches replayed between CUDA events) and a call from Python
(CUDA events over `iters` calls).

--sweep adds bank0's table with every lane inactive at 1, 4, 16, 64 and
256 staged waves (its 16 lanes a wave, its 512 account slots): the
device time against the number of wave steps, whose least-squares line
gives the launch's fixed cost and the cost of one bare step.

--root is the repository whose firedancer_tpu_torch is imported and
built (default: this one); a `git archive` of another commit unpacked
into a gitignored directory compares two versions of the kernel in one
run on one card (parent, change, change, parent). Prints one JSON line a
shape, then the card's name and power limit as nvidia-smi gives them.
chip_smoke.py phase 11 uses `shapes`, `run_shape` and `graph_ms`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

BANK_WAVE = (8, 31)       # bank0's wave at bench.py's shape: microblocks,
                          # transfers each
BANK_OBSERVED = (4, 12)   # the bank's wave in the leader topology
RAND_BLOCK = (4096, 768)  # transfers, accounts
GLOBAL_BLOCK = (16384, 40000)


def synth_transfers(n: int, seed: int):
    """n system transfers as the synth tile makes them (16 signers in
    turn, each to its own destination, an amount in [2^20, 2^31), the
    fee of one signature) -> (SystemTxn list, genesis {pubkey: 2^44}).
    Built without signing: the bank executes what the txns say."""
    from firedancer_tpu_torch.pack.scheduler import FEE_PER_SIGNATURE
    from firedancer_tpu_torch.svm.executor import SystemTxn
    from firedancer_tpu_torch.tiles.synth import synth_signer_seed
    from firedancer_tpu_torch.utils.ed25519_ref import keypair
    pubs = [keypair(synth_signer_seed(i))[2] for i in range(16)]
    rng = np.random.default_rng(seed)
    txns = [SystemTxn(pubs[i % 16], hashlib.sha256(b"dest-%d" % i).digest(),
                      int(rng.integers(1 << 20, 1 << 31)), FEE_PER_SIGNATURE)
            for i in range(n)]
    return txns, {p: 1 << 44 for p in pubs}


def u64_block(n: int, n_acct: int, seed: int):
    """A random block of n transfers over n_acct accounts with u64 edge
    values: balances up to 2^64 - 1 (a quarter at or above 2^63), amounts
    and fees near 2^63 and 2^64 so amount + fee wraps, hi-word borrows.
    -> (SystemTxn list, genesis {pubkey: u64})."""
    from firedancer_tpu_torch.svm.executor import SystemTxn
    rng = np.random.default_rng(seed)
    keys = [hashlib.sha256(b"acct-%d" % i).digest() for i in range(n_acct)]
    edges = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 64) - 1]

    def u64(p_edge):
        if rng.random() < p_edge:       # at an edge or just below it
            e = edges[rng.integers(len(edges))]
            return (e - int(rng.integers(0, 3))) % (1 << 64)
        return int(rng.integers(0, 1 << 62)) << int(rng.integers(0, 3))
    genesis = {k: u64(0.25) if i % 4
               else (1 << 63) + int(rng.integers(0, 1 << 62))
               for i, k in enumerate(keys)}
    txns = [SystemTxn(keys[rng.integers(n_acct)], keys[rng.integers(n_acct)],
                      u64(0.2), u64(0.1) >> int(rng.integers(0, 40)))
            for _ in range(n)]
    return txns, genesis


def wave_tables(txns, genesis):
    """The staged table of `txns` and the balance halves of its account
    slots, as WaveExecutor.stage and dispatch build them -> numpy
    (packed (Wp, Cp, 7) uint32, bal_hi, bal_lo (A,) uint32, W, C, active
    lanes)."""
    from firedancer_tpu_torch.svm import executor as texec
    key_idx = {}
    for t in txns:
        for k in (t.src, t.dst):
            key_idx.setdefault(k, len(key_idx))
    packed, tix, act = texec.pack_table(txns, key_idx)
    n = texec._bucket(len(key_idx) + 1)
    hi, lo = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    for k, i in key_idx.items():
        v = genesis.get(k, 0)
        hi[i], lo[i] = v >> 32, v & 0xFFFFFFFF
    return packed, hi, lo, tix.shape[0], tix.shape[1], int(act.sum())


def shapes(bank_txns=None, bank_gen=None) -> list:
    """-> [(name, txns, genesis, wave_tables(...))] for phase 11's five
    shapes; bank_txns, bank_gen: bank0's wave if the caller made it."""
    if bank_txns is None:
        bank_txns, bank_gen = synth_transfers(BANK_WAVE[0] * BANK_WAVE[1],
                                              17)
    obs_txns, obs_gen = synth_transfers(BANK_OBSERVED[0] * BANK_OBSERVED[1],
                                        21)
    rand_txns, rand_gen = u64_block(*RAND_BLOCK, 18)
    glob_txns, glob_gen = u64_block(*GLOBAL_BLOCK, 19)
    out = [(name, txns, gen, wave_tables(txns, gen)) for name, txns, gen in (
        ("wave_scan", bank_txns, bank_gen),
        ("wave_scan@bank_observed", obs_txns, obs_gen),
        ("wave_scan@random", rand_txns, rand_gen),
        ("wave_scan@global_balances", glob_txns, glob_gen))]
    packed, hi, lo, w, c, _ = out[0][3]
    idle = packed.copy()
    idle[..., 6] = 0
    out.append(("wave_scan@inactive", [], bank_gen,
                (idle, hi, lo, w, c, 0)))
    return out


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call of `fn`, its `iters` calls captured in one
    CUDA graph and replayed between CUDA events: the kernels' own time,
    without the host's launch cost between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _events_ms(fn, iters: int) -> float:
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


def run_shape(cuda_wave, tables, iters: int, dev) -> dict:
    """The kernel against the plain version on one shape's tables, then
    its times. -> {err (max abs over balances and statuses), statuses
    (kernel's, numpy), equal_statuses, ms (device), call_ms, plain_ms,
    W, C, staged, A, plan (None where the wrapper has no plan)}."""
    packed, hi, lo, w, c, _ = tables
    ins = [torch.from_numpy(x).to(dev) for x in (packed, hi, lo)]
    got = [x.cpu().numpy() for x in cuda_wave.wave_scan(*ins)]
    want = [x.cpu().numpy() for x in cuda_wave.wave_scan_plain(*ins)]
    torch.cuda.synchronize()
    err = max(int(np.abs(g.astype(np.int64) - v.astype(np.int64)).max(
        initial=0)) for g, v in zip(got, want))
    plan = getattr(cuda_wave, "plan", None)
    return {
        "err": err, "statuses": got[2],
        "equal_statuses": bool(np.array_equal(got[2], want[2])),
        "ms": graph_ms(lambda: cuda_wave.wave_scan(*ins), iters),
        "call_ms": _events_ms(lambda: cuda_wave.wave_scan(*ins), iters),
        "plain_ms": _events_ms(lambda: cuda_wave.wave_scan_plain(*ins), 1),
        "W": w, "C": c, "staged": list(packed.shape[:2]), "A": len(hi),
        "plan": plan(*packed.shape[:2], len(hi)) if plan else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wave_bench")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wave_bench: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from firedancer_tpu_torch.ops import cuda_wave
    dev = torch.device("cuda")
    for name, _, _, tables in shapes():
        r = run_shape(cuda_wave, tables, args.iters, dev)
        if r["err"] or not r["equal_statuses"]:
            raise AssertionError(f"{name}: kernel != plain ({r['err']})")
        r.pop("statuses")
        print(json.dumps({"shape": name, "root": args.root,
                          "source": cuda_wave.__file__, **r}), flush=True)
        if name == "wave_scan@inactive":
            idle = tables
    if args.sweep:
        steps, ms = [1, 4, 16, 64, 256], []
        for n in steps:
            packed = np.resize(idle[0], (n,) + idle[0].shape[1:])
            r = run_shape(cuda_wave, (packed,) + idle[1:], args.iters, dev)
            assert r["err"] == 0 and r["equal_statuses"]
            ms.append(r["ms"])
        slope, fixed = np.polyfit(steps, ms, 1)
        print(json.dumps({"sweep": "inactive", "root": args.root,
                          "steps": steps, "ms": ms, "fixed_ms": fixed,
                          "step_ms": slope}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
