"""The SHA-256 kernel's two entries (csrc/sha256.cu) measured on the card.

    python firedancer_tpu_torch/tools/sha256_bench.py [--root DIR] \\
        [--iters 20] [--pipes]

Prints one JSON line each for:
  * `ptxas`: registers, spills and stack of each entry, from the build log;
  * `sass`: each kernel's loops of 200 instructions or more in the SASS
    (`cuobjdump -sass` on the built library), counted by opcode and by
    pipe (ALU: LOP3, SHF, IADD3, PRMT, SEL, ...; FMA: the IMAD forms). The
    round warp's loop (`round_loop`: the one with the most funnel-shift
    rotates) is one compression of `poh_verify`, one block of `sha256`;
  * `poh`: `poh_verify` on entries of up to H hashes (H = 64, as in
    cfg/leader.toml, 4096, and mainnet's 12,500), 32 entries in each
    warp (ragged counts, mixins) and, at 64 and 4096, 16 (the warp's
    other lanes given 0 hashes: its first 16 lanes, or its even ones),
    each verdict held to the host chain, the time (CUDA events over
    `iters` calls from Python, and a CUDA graph of `iters` launches) and
    the clocks a round at the 1.98 GHz boost;
  * `sha256`: the digest entry at the shapes its paths run (8192 rows of
    0-1296 bytes at widths 1296 and 1297 and at base offsets 1-3; the
    leaf level of chip_smoke.py's 64 bmtree trees, 4096 rows of 58 bytes,
    and a node level, 2048 rows of 90; the 64 shred leaves of 1070 bytes),
    each held to hashlib, and the two times;
  * with --pipes, `pipe`: tools/pipe_bench.cu's issue rates of LOP3, SHF,
    IMAD, IMAD.HI, IADD, PRMT and SHFL (within groups of four lanes)
    alone and in pairs, on one warp an SM,
    with 32 and 16 active lanes, and their dependent latencies; `place`:
    where the warps of a launch land (SM, sub-partition) and their rate;
    and a named-barrier round trip between two warps.
Then the card's name and power limit as nvidia-smi gives them, and its
SM clock.

--root is the repository whose firedancer_tpu_torch is imported and
built (default: this one); a `git archive` of another commit unpacked
into a gitignored directory compares two versions of the kernel on one
card (parent, change, change, parent)."""
from __future__ import annotations

import argparse
import collections
import ctypes as ct
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

CLOCK_HZ = 1.98e9
PIPES = {
    "ALU": ("LOP3", "SHF", "IADD3", "PRMT", "SEL", "ISETP", "LEA", "MOV",
            "IMNMX", "SHL", "SHR", "PLOP3", "IABS", "FLO", "POPC", "BMSK",
            "SGXT", "LOP"),
    "FMA": ("IMAD",),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    for pipe, ops in PIPES.items():
        if base in ops:
            return pipe
    return "other"


def parse_sass(text: str) -> dict:
    """cuobjdump -sass text -> {kernel: [[address, opcode, branch target
    address or None]]}."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            continue
        m = _LABEL.match(line)
        if m and cur is not None:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m or cur is None:
            continue
        addr, body = int(m.group(1), 16), m.group(2)
        for lab in pending:
            cur[1][lab] = addr
        pending = []
        words = [w for w in body.split() if not w.startswith("@")]
        if not words:
            continue
        target = None
        if words[0].startswith("BRA"):
            t = re.search(r"\((\.L_x_\d+)\)", body)
            h = re.search(r"\b0x([0-9a-f]+)\b", body)
            target = t.group(1) if t else int(h.group(1), 16) if h else None
        cur[0].append([addr, words[0], target])
    for insns, labels in funcs.values():
        for ins in insns:
            if isinstance(ins[2], str):
                ins[2] = labels.get(ins[2])
    return {name: insns for name, (insns, _) in funcs.items()}


def loops(insns, min_len: int = 200) -> list:
    """Backward branches spanning min_len instructions or more: [{from,
    to, instrs, ops, pipes}], counted over [target, branch]."""
    out = []
    for i, (addr, op, tgt) in enumerate(insns):
        if not isinstance(tgt, int) or tgt > addr:
            continue
        body = [x for x in insns if tgt <= x[0] <= addr]
        if len(body) < min_len:
            continue
        ops = collections.Counter(x[1] for x in body)
        pipes = collections.Counter(pipe_of(x[1]) for x in body)
        out.append({"from": hex(tgt), "to": hex(addr), "instrs": len(body),
                    "pipes": dict(pipes), "ops": dict(ops.most_common())})
    return out


def round_loop(sass: dict, kernel: str) -> dict:
    """The innermost loop of `kernel` (a substring of its mangled name) in
    sass_report's `sass` that holds the most SHF.R.W rotates: the round
    warp's loop, one compression. (A branch back over code laid out
    between a loop's parts spans more than a loop: innermost drops it.)"""
    loops = next(v for k, v in sass.items() if kernel in k)
    span = [(int(lp["from"], 16), int(lp["to"], 16)) for lp in loops]
    inner = [lp for lp, (a, b) in zip(loops, span)
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in span)]
    return max(inner, key=lambda lp: lp["ops"].get("SHF.R.W.U32", 0)
               + lp["ops"].get("SHF.L.W.U32.HI", 0))


def cuobjdump() -> str:
    from firedancer_tpu_torch.ops import _build
    return os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")


def sass_report(so: str) -> dict:
    text = subprocess.run([cuobjdump(), "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {k: loops(v) for k, v in parse_sass(text).items()}


def cuda_ms(fn, iters: int) -> float:
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


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call of `fn`, its `iters` calls captured in one
    CUDA graph and replayed between CUDA events: the kernels' own time,
    without the host's cost of a call from Python between them."""
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


def poh_case(hashes: int, warps: int, layout: str, seed: int):
    """Entries of up to `hashes` hashes, 32 a warp over `warps` warps;
    layout "32" fills every lane (every fourth entry with a mixin, the
    counts ragged below `hashes` by lane % 3, so a warp's lanes end their
    chains apart), "16lo" the first 16 lanes of each warp and "16even" the
    even lanes with `hashes` plain hashes (the others get 0 hashes).
    -> (prev, num, mixin, has, expected) arrays, expected verdicts."""
    from firedancer_tpu_torch.ops.poh import host_poh_append, host_poh_mixin
    n = 32 * warps
    lane = np.arange(n) % 32
    act = {"32": np.ones(n, bool), "16lo": lane < 16,
           "16even": lane % 2 == 0}[layout]
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (n, 32), np.uint8)
    mix = rng.integers(0, 256, (n, 32), np.uint8)
    has = (lane % 4 == 1) & (layout == "32")
    num = np.where(act, hashes - (lane % 3 if layout == "32" else 0), 0)
    num = num.astype(np.int32)
    exp = prev.copy()
    for i in np.flatnonzero(act):
        s = host_poh_append(prev[i].tobytes(), int(num[i] - has[i]))
        if has[i]:
            s = host_poh_mixin(s, mix[i].tobytes())
        exp[i] = np.frombuffer(s, np.uint8)
    return (prev, num, mix, has, exp), act


def sha256_cases(rng) -> list:
    """(name, flat uint8 buffer, offset, rows, width, lens) at the paths'
    shapes."""
    out = []

    def case(name, n, width, lo, hi, off=0, edges=()):
        lens = rng.integers(lo, hi + 1, n).astype(np.int32)
        lens[:len(edges)] = edges
        flat = rng.integers(0, 256, n * width + off, np.uint8)
        out.append((name, flat, off, n, width, lens))
    edges = (0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 1295, 1296)
    for w in (1296, 1297):
        case(f"rows8192x{w}", 8192, w, 0, 1296, 0, edges)
    for off in (1, 2, 3):
        case(f"rows8192x1296+{off}", 8192, 1296, 0, 1296, off, edges)
    case("bmtree_leaves4096x58", 4096, 58, 58, 58)
    case("bmtree_nodes2048x90", 2048, 90, 90, 90)
    case("shred_leaves64x1070", 64, 1070, 1070, 1070)
    return out


def run_sha256(cuda_sha256, dev, iters: int, rng) -> list:
    res = []
    for name, flat, off, n, width, lens in sha256_cases(rng):
        buf = torch.from_numpy(flat).to(dev)
        m = buf[off:off + n * width].view(n, width)
        ln = torch.from_numpy(lens).to(dev)
        got = cuda_sha256.sha256(m, ln).cpu().numpy()
        rows = flat[off:off + n * width].reshape(n, width)
        want = np.stack([np.frombuffer(hashlib.sha256(
            rows[i, :k].tobytes()).digest(), np.uint8)
            for i, k in enumerate(lens)])
        assert np.array_equal(got, want), f"sha256 {name} != hashlib"
        res.append({"sha256": name, "ptr_mod16": m.data_ptr() % 16,
                    "blocks": int(((lens + 72) // 64).sum()),
                    "longest_blocks": int((lens.max() + 72) // 64),
                    "ms": cuda_ms(lambda: cuda_sha256.sha256(m, ln), iters),
                    "graph_ms": graph_ms(lambda: cuda_sha256.sha256(m, ln),
                                         iters)})
    return res


def run_poh(cuda_sha256, dev, iters: int) -> list:
    res = []
    for hashes, layouts in ((64, ("32", "16lo", "16even")),
                            (4096, ("32", "16lo", "16even")),
                            (12500, ("32",))):
        for layout in layouts:
            warps = 8 if layout == "32" else 16
            args, want = poh_case(hashes, warps, layout, hashes + warps)
            t = [torch.from_numpy(a).to(dev) for a in args]
            got = cuda_sha256.poh_verify(*t, hashes).cpu().numpy()
            assert np.array_equal(got, want), (hashes, layout)
            ms = graph_ms(lambda: cuda_sha256.poh_verify(*t, hashes), iters)
            res.append({"poh": f"{hashes}x{layout}", "entries": len(want),
                        "active": int(want.sum()),
                        "ms": cuda_ms(lambda: cuda_sha256.poh_verify(
                            *t, hashes), iters),
                        "graph_ms": ms,
                        "clocks_a_round": ms * 1e-3 * CLOCK_HZ
                        / (hashes * 64)})
    return res


def run_pipes(dev) -> list:
    from firedancer_tpu_torch.ops import _build
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pipe_bench.cu")
    so = os.path.join(_build.BUILD, "libpipe_bench.so")
    os.makedirs(_build.BUILD, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, timeout=600)
    fn = ct.CDLL(so).fdtt_pipe_bench
    fn.restype = ct.c_int
    fn.argtypes = [ct.c_int] * 4 + [ct.c_uint, ct.c_void_p, ct.c_int,
                                    ct.c_void_p]
    names = ["LOP3", "SHF", "IMAD", "IMAD.HI", "IADD", "PRMT", "LOP3+IMAD",
             "SHF+IMAD", "LOP3+SHF", "SHF+IMAD.HI", "SHFL", "SHF+SHFL"]
    blocks, iters = torch.cuda.get_device_properties(dev).multi_processor_count, 4096
    out = torch.zeros(2 * blocks, dtype=torch.int64, device=dev)
    res = []
    for kind, name in enumerate(names):
        for chains in (8, 1):
            for active in (32, 16):
                rc = fn(kind, chains, iters, active, 0x9E3779B9,
                        out.data_ptr(), blocks,
                        torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
                torch.cuda.synchronize()
                cyc = float(np.median(out[0::2].cpu().numpy()))
                res.append({"pipe": name, "chains": chains,
                            "active": active,
                            "clocks_an_instr": cyc / (iters * 16 * chains)})
    lib = ct.CDLL(so)
    place = lib.fdtt_place_bench
    place.restype = ct.c_int
    place.argtypes = [ct.c_int] * 3 + [ct.c_uint, ct.c_void_p, ct.c_void_p]
    for nblk, warps in ((blocks, 1), (2 * blocks, 1), (blocks, 2),
                        (blocks, 4)):
        o = torch.zeros(3 * nblk * warps, dtype=torch.int64, device=dev)
        assert place(nblk, warps, 1024, 0x9E3779B9, o.data_ptr(),
                     torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        cyc, sm, slot = o.view(-1, 3).cpu().numpy().T
        per = cyc / (1024 * 16 * 8)
        shared = collections.Counter(zip(sm.tolist(), (slot % 4).tolist()))
        res.append({"place": f"{nblk}x{warps}",
                    "clocks_an_instr": [float(per.min()),
                                        float(np.median(per)),
                                        float(per.max())],
                    "sms": len(set(sm.tolist())),
                    "most_warps_on_a_subpartition": max(shared.values()),
                    "first_block_slots": slot[:warps].tolist()})
    pp = lib.fdtt_pingpong_bench
    pp.restype = ct.c_int
    pp.argtypes = [ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p]
    o = torch.zeros(blocks, dtype=torch.int64, device=dev)
    assert pp(blocks, 4096, o.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    res.append({"pingpong_clocks_a_round_trip":
                float(np.median(o.cpu().numpy())) / 4096})
    res.append({"pipe_sass": sass_report(so)})
    return res


def ptxas_report(log: str) -> list:
    out, fn = [], None
    for line in open(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append({"kernel": fn, "line": line.strip()})
        if "spill" in line and fn:
            out.append({"kernel": fn, "line": line.strip()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sha256_bench")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pipes", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sha256_bench: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from firedancer_tpu_torch.ops import _build, cuda_sha256
    dev = torch.device("cuda")
    _build.build_all(("sha256",))
    _, so, log = _build._paths("sha256")
    tag = {"root": args.root}
    for r in ptxas_report(log):
        print(json.dumps({"ptxas": r, **tag}), flush=True)
    print(json.dumps({"sass": sass_report(so), **tag}), flush=True)
    for r in run_poh(cuda_sha256, dev, args.iters):
        print(json.dumps({**r, **tag}), flush=True)
    for r in run_sha256(cuda_sha256, dev, args.iters,
                        np.random.default_rng(7)):
        print(json.dumps({**r, **tag}), flush=True)
    if args.pipes:
        for r in run_pipes(dev):
            print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
