"""The BLAKE3 kernel's two entries (csrc/blake3.cu) measured on the card.

    python firedancer_tpu_torch/tools/blake3_bench.py [--root DIR] \\
        [--iters 20] [--sweep]

Prints one JSON line each for:
  * `ptxas`: registers, spills and stack of each kernel, from the build
    log;
  * `sass`: for each kernel, its innermost loops of 200 instructions or
    more in the SASS (`cuobjdump -sass` on the built library), each
    counted by opcode and by pipe (ALU: LOP3, SHF, IADD3, PRMT, SEL, ...;
    FMA: the IMAD forms; MIO: SHFL and the shared and global loads and
    stores), with `rotates` (SHF.R.W / SHF.L.W and PRMT: 4 a G function);
    `compression` is the one with the most rotates, the loop that runs a
    chain's compressions;
  * `shape`: an entry at one shape, held to its plain version
    (ops/blake3.py) on every lane and to blake3_ref on the first 32: the
    shapes are `phase15` (chip_smoke.py phase 15: 4096 lanes of 0-2048
    bytes at width 2048, the block and chunk edges first) and `bank_hash`
    (4096 lanes of 81 bytes at width 81: the serialized data-less system
    account that flamenco/bank_hash.py hashes, every row at another
    alignment). Each line gives `graph_ms` (a CUDA graph of `iters`
    launches replayed between CUDA events: the kernel's own time),
    `call_ms` (CUDA events over `iters` calls from Python), the work
    (`compressions`, `ops`, `bytes`), `bound_ms` (the larger of ops over
    the INT32 rate, 132 SMs x 64 lanes x 1.98 GHz, and bytes over 3.35
    TB/s) and `bound_by`, `longest` (the compressions of the longest
    message one after another: its chunks' blocks, then the root),
    `clocks_a_compression` (graph_ms at 1.98 GHz over `longest`), and
    `chain` and `chain_floor_ms` (the longest message's chain with its
    chunks side by side, at a compression's dependent latency: `work`);
  * with --sweep, `shape` lines at 4096 x 2048 bytes (every message two
    chunks), 4096 x 1024 (one full chunk), 16,384 and 65,536 x 81, held
    to the plain version on their first 256 lanes.
Then the card's name and power limit as nvidia-smi gives them, and its
SM clock.

--root is the repository whose firedancer_tpu_torch is imported and
built (default: this one); a `git archive` of another commit unpacked
into a gitignored directory compares two versions of the kernel on one
card (parent, change, change, parent). chip_smoke.py phase 15 uses
`work`."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
BYTES_PER_S = 3.35e12
# a compression: 7 rounds of 8 G functions of 12 32-bit operations (4
# adds, 4 xors, 4 rotates), then 8 output xors (16 for an XOF block)
BLAKE3_OPS = 7 * 8 * 12 + 8
BLAKE3_XOF_OPS = 7 * 8 * 12 + 16
# a compression's dependent chain: 14 G functions one after another (the
# column and diagonal steps of 7 rounds), 12 dependent instructions each,
# at the 4.5 clocks a dependent integer instruction waits on an NVIDIA
# H100 80GB HBM3 (tools/pipe_bench.cu, PERF.md §6)
CHAIN_CLOCKS = 14 * 12 * 4.5
PHASE15_EDGES = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2047, 2048, 3)
BANK_HASH_LEN = 81        # 8 + 8 + 0 data + 1 + 32 + 32 bytes
MIO = ("SHFL", "LDS", "STS", "LDG", "STG", "LDSM", "LDGSTS", "BAR", "LD",
       "ST")


def work(lens, entry: str) -> dict:
    """The compressions, INT32 operations and bytes that `entry`
    ("blake3" or "lthash") needs for messages of these lengths: each
    chunk's blocks chain (a one-chunk message's last block runs only as
    the root), then the root: 1 compression for the digest, 32 for the
    XOF. `longest` is the longest message's compressions one after
    another; `chain` the same with its two chunks side by side (the
    longer chunk's chain, then the root or one XOF block), and
    `chain_floor_ms` that many compressions at CHAIN_CLOCKS each."""
    n = np.asarray(lens, np.int64)
    nb = np.maximum(1, -(-n // 64))
    chain = np.where(n <= 1024, nb - 1, 16 + -(-(n - 1024) // 64))
    roots, rops, out = ((1, BLAKE3_OPS, 32) if entry == "blake3"
                        else (32, BLAKE3_XOF_OPS, 4096))
    ops = int(chain.sum()) * BLAKE3_OPS + len(n) * roots * rops
    nbytes = int(n.sum()) + len(n) * (4 + out)
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    side = int(np.where(n <= 1024, nb - 1, 16).max()) + 1
    return dict(compressions=int(chain.sum()) + len(n) * roots, ops=ops,
                bytes=nbytes, ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                longest=int(chain.max()) + 1, chain=side,
                chain_floor_ms=side * CHAIN_CLOCKS / CLOCK_HZ * 1e3)


def rows(n: int, width: int, lo: int, hi: int, seed: int, edges=()):
    """(n, width) uint8 rows of random lengths in [lo, hi] (`edges`
    first), random below each length and zero past it; (n,) int32."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n).astype(np.int32)
    lens[:len(edges)] = edges
    msg = rng.integers(0, 256, (n, width), np.uint8)
    msg[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msg, lens


def shapes(sweep: bool) -> list:
    """(name, rows, lanes held to the plain version or None for all)."""
    out = [("phase15", rows(4096, 2048, 0, 2048, 15, PHASE15_EDGES), None),
           ("bank_hash", rows(4096, BANK_HASH_LEN, BANK_HASH_LEN,
                              BANK_HASH_LEN, 81), None)]
    if sweep:
        out += [("full2048", rows(4096, 2048, 2048, 2048, 1), 256),
                ("chunk1024", rows(4096, 1024, 1024, 1024, 2), 256),
                ("bank_hash16k", rows(16384, BANK_HASH_LEN, BANK_HASH_LEN,
                                      BANK_HASH_LEN, 3), 256),
                ("bank_hash64k", rows(65536, BANK_HASH_LEN, BANK_HASH_LEN,
                                      BANK_HASH_LEN, 4), 256)]
    return out


def run_shape(name, msg, lens, check, dev, iters, sb) -> list:
    from firedancer_tpu_torch.ops import blake3 as b3, cuda_blake3
    from firedancer_tpu_torch.utils import blake3_ref
    m, ln = torch.from_numpy(msg).to(dev), torch.from_numpy(lens).to(dev)
    res = []
    for entry, kern, plain in (("blake3", cuda_blake3.blake3, b3.blake3_plain),
                               ("lthash", cuda_blake3.lthash, b3.lthash_plain)):
        got = kern(m, ln)
        k = len(lens) if check is None else check
        want = plain(m[:k], ln[:k])
        assert torch.equal(got[:k], want), f"{entry} {name}: kernel != plain"
        got_h = got[:32].cpu().numpy()
        for i in range(min(32, len(lens))):
            row = msg[i, :lens[i]].tobytes()
            ref = (np.frombuffer(blake3_ref.blake3(row), np.uint8)
                   if entry == "blake3" else
                   np.frombuffer(blake3_ref.lthash(row), np.uint16))
            assert np.array_equal(got_h[i], ref), (entry, name, i)
        w = work(lens, entry)
        g = sb.graph_ms(lambda: kern(m, ln), iters)
        res.append({"shape": name, "entry": entry, "lanes": len(lens),
                    "width": msg.shape[1], "held_to_plain": k,
                    "graph_ms": g, "call_ms": sb.cuda_ms(lambda: kern(m, ln),
                                                         iters),
                    **w, "times_bound": g / w["bound_ms"],
                    "clocks_a_compression": g * 1e-3 * CLOCK_HZ
                    / w["longest"]})
    return res


def sass_loops(sb, so: str) -> dict:
    """{kernel: {"loops": innermost loops, "compression": the one with
    the most rotates}} from sha256_bench's sass_report."""
    out = {}
    for kern, lps in sb.sass_report(so).items():
        span = [(int(lp["from"], 16), int(lp["to"], 16)) for lp in lps]
        inner = [lp for lp, (a, b) in zip(lps, span)
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in span)]
        for lp in inner:
            lp["rotates"] = sum(v for op, v in lp["ops"].items()
                                if op.startswith(("SHF.R.W", "SHF.L.W",
                                                  "PRMT")))
            lp["pipes"]["MIO"] = sum(v for op, v in lp["ops"].items()
                                     if op.split(".")[0] in MIO)
            lp["pipes"]["other"] = lp["pipes"].get("other", 0) \
                - lp["pipes"]["MIO"]
        out[kern] = {"loops": inner, "compression": max(
            inner, key=lambda lp: lp["rotates"]) if inner else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="blake3_bench")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blake3_bench: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from firedancer_tpu_torch.ops import _build
    from firedancer_tpu_torch.tools import sha256_bench as sb
    dev = torch.device("cuda")
    _build.build_all(("blake3",))
    _, so, log = _build._paths("blake3")
    tag = {"root": args.root}
    for r in sb.ptxas_report(log):
        print(json.dumps({"ptxas": r, **tag}), flush=True)
    print(json.dumps({"sass": sass_loops(sb, so), **tag}), flush=True)
    for name, (msg, lens), check in shapes(args.sweep):
        for r in run_shape(name, msg, lens, check, dev, args.iters, sb):
            print(json.dumps({**r, **tag}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
