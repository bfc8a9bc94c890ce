"""Build of the CUDA sources under csrc/ with nvcc at first use, and
their ctypes loader.

Each `csrc/<name>.cu` has plain C entry points and becomes
`build/lib<name>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source, or a header under csrc/, is
newer. `build_all` starts one
nvcc per source at once and waits for all of them; ptxas's register and
spill report lands in `build/<name>.log`. Nothing here is imported or
run on the CPU path."""
from __future__ import annotations

import ctypes as ct
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("sha512", "ed25519_verify", "ed25519_msm", "wave_scan", "sha256",
           "blake3")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD, f"lib{name}.so"),
            os.path.join(BUILD, f"{name}.log"))


def _stale(name: str) -> bool:
    src, so, _ = _paths(name)
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return (not os.path.exists(so)
            or os.path.getmtime(so) < max(map(os.path.getmtime, deps)))


def _start(name: str):
    src, so, log = _paths(name)
    tmp = f"{so}.{os.getpid()}.tmp"
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def build_all(names=SOURCES) -> dict:
    """Compile every stale source in parallel. -> {name: (seconds,
    compiler output)} for the sources compiled by this call."""
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names if _stale(n)}
    done = {}
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        _, so, log = _paths(name)
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, out)
    return done


def lib(name: str, argtypes, entry: str | None = None):
    """Entry point `entry` (default fdtt_<name>) of the library of
    csrc/<name>.cu, built first if needed, with `argtypes` set."""
    entry = entry or f"fdtt_{name}"
    if (name, entry) not in _libs:
        if _stale(name):
            build_all((name,))
        fn = getattr(ct.CDLL(_paths(name)[1]), entry)
        fn.restype = ct.c_int
        fn.argtypes = argtypes
        _libs[name, entry] = fn
    return _libs[name, entry]


def check_launch(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
