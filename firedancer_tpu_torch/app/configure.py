"""`configure` — system preflight stages (check / fix); a copy of the
JAX package's app/configure.py: the stages `shm`, `hugepages`,
`nofile`, `memlock`, `cpus`, `somaxconn`, `overcommit`, `check`, `fix`
and the CLI.

The reference's configure command runs privileged stages before boot:
hugetlbfs mounts, sysctl tuning, ethtool channels, hyperthread
isolation (ref: src/app/shared/commands/configure/, listed in
src/app/fdctl/main.c:33-42). This framework's runtime needs are
narrower — /dev/shm capacity for workspaces, fd limits for rings and
sockets, scheduling headroom for pinned tiles — and the container
environments it runs in rarely grant root. So each stage follows the
reference's check/fix contract, but `fix` only applies what the
process may legally do (rlimits up to the hard cap); everything else
reports a clear PASS/WARN/FAIL with the operator command that would
fix it. Nothing is written under /proc or /sys: the stages only read
there. As in the reference there is no device stage: a tile on the
card fails its own boot when its kernels do not build or launch.

Where the copy differs from the reference: the shm stage's hint names
the port's workspaces (`/dev/shm/fdtt_*`).

CLI:  python -m firedancer_tpu_torch.app.configure check [--wksp-bytes N]
      python -m firedancer_tpu_torch.app.configure fix
"""
from __future__ import annotations

import json
import os
import resource
import sys

PASS, WARN, FAIL = "PASS", "WARN", "FAIL"


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def stage_shm(wksp_bytes: int = 1 << 30) -> dict:
    """The workspace backing store must hold the planned topology:
    /dev/shm normally, or the FDTPU_HUGETLBFS mount when workspaces
    are redirected there (native/fdtpu.cc wksp_open_fd)."""
    backing = os.environ.get("FDTPU_HUGETLBFS") or "/dev/shm"
    st = {"stage": "shm", "status": FAIL, "detail": "", "fix": ""}
    try:
        s = os.statvfs(backing)
    except OSError as e:
        st["detail"] = f"{backing} unavailable: {e}"
        st["fix"] = "mount -t tmpfs -o size=2g tmpfs /dev/shm"             if backing == "/dev/shm" else             f"mount hugetlbfs at {backing} or unset FDTPU_HUGETLBFS"
        return st
    free = s.f_bavail * s.f_frsize
    total = s.f_blocks * s.f_frsize
    st["detail"] = (f"{backing}: free {free >> 20} MiB of "
                    f"{total >> 20} MiB, want {wksp_bytes >> 20} MiB")
    if free >= wksp_bytes:
        st["status"] = PASS
    elif total >= wksp_bytes:
        st["status"] = WARN
        st["fix"] = "remove stale /dev/shm/fdtt_* workspaces"
    else:
        st["fix"] = (f"mount -o remount,size="
                     f"{max(total, wksp_bytes * 2) >> 20}m /dev/shm")
    return st


def _rl_ge(v: int, want: int) -> bool:
    """limit >= want with RLIM_INFINITY treated as unbounded."""
    return v == resource.RLIM_INFINITY or v >= want


def stage_nofile(want: int = 4096) -> dict:
    """fd headroom: rings, sockets, mmaps (the reference raises
    RLIMIT_NOFILE in its boot path)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    st = {"stage": "nofile", "status": PASS,
          "detail": f"soft {soft}, hard {hard}, want {want}", "fix": ""}
    if not _rl_ge(soft, want):
        st["status"] = WARN if _rl_ge(hard, want) else FAIL
        st["fix"] = (f"raise soft limit (fix stage does this up to "
                     f"hard={hard})" if _rl_ge(hard, want)
                     else f"ulimit -n {want} as root / raise hard cap")
    return st


def fix_nofile(want: int = 4096) -> bool:
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if _rl_ge(soft, want):
        return True
    try:
        new_soft = want if _rl_ge(hard, want) else hard
        resource.setrlimit(resource.RLIMIT_NOFILE, (new_soft, hard))
        return _rl_ge(resource.getrlimit(resource.RLIMIT_NOFILE)[0],
                      want)
    except (ValueError, OSError):
        return False


def stage_memlock(want: int = 1 << 26) -> dict:
    """Locked-memory headroom (device staging buffers pin pages)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    inf = resource.RLIM_INFINITY

    def fmt(v):
        return "unlimited" if v == inf else f"{v >> 20} MiB"
    st = {"stage": "memlock", "status": PASS,
          "detail": f"soft {fmt(soft)}, hard {fmt(hard)}", "fix": ""}
    if soft != inf and soft < want:
        st["status"] = WARN if (hard == inf or hard >= want) else FAIL
        st["fix"] = "raise RLIMIT_MEMLOCK (fix stage tries up to hard)"
    return st


def fix_memlock(want: int = 1 << 26) -> bool:
    """True only when the resulting soft limit actually covers `want`
    (raising toward a too-small hard cap is progress, not success —
    same contract as fix_nofile)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    if _rl_ge(soft, want):
        return True
    try:
        new_soft = want if _rl_ge(hard, want) else hard
        resource.setrlimit(resource.RLIMIT_MEMLOCK, (new_soft, hard))
        return _rl_ge(resource.getrlimit(resource.RLIMIT_MEMLOCK)[0],
                      want)
    except (ValueError, OSError):
        return False


def stage_cpus(want: int = 4) -> dict:
    """Schedulable cores vs the topology's tile count (tile pinning
    needs distinct cores to mean anything)."""
    avail = len(os.sched_getaffinity(0))
    st = {"stage": "cpus", "status": PASS if avail >= want else WARN,
          "detail": f"{avail} schedulable cores, want {want} for "
                    f"pinned tiles", "fix": ""}
    if avail < want:
        st["fix"] = ("tiles will timeshare cores; reduce topology or "
                     "widen the cpuset")
    return st


def stage_somaxconn(want: int = 128) -> dict:
    """Listen backlog for the rpc/gui/grpc services."""
    raw = _read("/proc/sys/net/core/somaxconn")
    if raw is None:
        return {"stage": "somaxconn", "status": WARN,
                "detail": "procfs unavailable", "fix": ""}
    v = int(raw)
    return {"stage": "somaxconn",
            "status": PASS if v >= want else WARN,
            "detail": f"{v}, want {want}",
            "fix": "" if v >= want else
            f"sysctl -w net.core.somaxconn={want}"}


def stage_overcommit() -> dict:
    """Heuristic overcommit: large sparse mmaps (groove volumes) need
    mode 0 or 1."""
    raw = _read("/proc/sys/vm/overcommit_memory")
    if raw is None:
        return {"stage": "overcommit", "status": WARN,
                "detail": "procfs unavailable", "fix": ""}
    v = int(raw)
    return {"stage": "overcommit",
            "status": PASS if v in (0, 1) else WARN,
            "detail": f"vm.overcommit_memory={v}",
            "fix": "" if v in (0, 1) else
            "sysctl -w vm.overcommit_memory=0"}


def stage_hugepages() -> dict:
    """Hugepage availability (the reference mounts hugetlbfs for its
    workspaces; ours use them when FDTPU_HUGETLBFS names a mount —
    native/fdtpu.cc wksp_open_fd)."""
    total = 0
    raw = _read("/proc/meminfo") or ""
    for line in raw.splitlines():
        if line.startswith("HugePages_Total"):
            total = int(line.split()[1])
    mounts = []
    for line in (_read("/proc/mounts") or "").splitlines():
        f = line.split()
        if len(f) >= 3 and f[2] == "hugetlbfs":
            # /proc/mounts octal-escapes spaces etc. (\040)
            mp = f[1].encode().decode("unicode_escape")
            mounts.append(os.path.realpath(mp))
    env_raw = os.environ.get("FDTPU_HUGETLBFS", "")
    env = os.path.realpath(env_raw.rstrip("/")) if env_raw else ""
    st = {"stage": "hugepages", "status": PASS,
          "detail": f"HugePages_Total={total}, mounts={mounts or '-'}"
                    f", FDTPU_HUGETLBFS={env_raw or '-'}", "fix": ""}
    if env and env not in mounts:
        st["status"] = WARN
        st["fix"] = (f"FDTPU_HUGETLBFS={env_raw} is not a hugetlbfs "
                     f"mount; workspaces get normal pages there")
    elif total == 0:
        st["status"] = WARN
        st["fix"] = ("no hugepages reserved; THP madvise still "
                     "applies — for guaranteed pages: sysctl -w "
                     "vm.nr_hugepages=N and mount hugetlbfs, then set "
                     "FDTPU_HUGETLBFS")
    return st


def check(wksp_bytes: int = 1 << 30) -> list[dict]:
    return [stage_shm(wksp_bytes), stage_hugepages(), stage_nofile(),
            stage_memlock(), stage_cpus(), stage_somaxconn(),
            stage_overcommit()]


def fix(wksp_bytes: int = 1 << 30) -> list[dict]:
    """Apply the unprivileged fixes, then re-check at the same
    target."""
    fix_nofile()
    fix_memlock()
    return check(wksp_bytes)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="firedancer_tpu_torch.app.configure",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("action", choices=["check", "fix"])
    ap.add_argument("--wksp-bytes", type=int, default=1 << 30)
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 1
    wksp = args.wksp_bytes
    stages = fix(wksp) if args.action == "fix" else check(wksp)
    worst = PASS
    for st in stages:
        line = f"[{st['status']:4s}] {st['stage']:<10s} {st['detail']}"
        if st["fix"]:
            line += f"  -> {st['fix']}"
        print(line)
        if st["status"] == FAIL or (st["status"] == WARN
                                    and worst == PASS):
            worst = st["status"]
    print(json.dumps({"result": worst}))
    return 0 if worst != FAIL else 2


if __name__ == "__main__":
    sys.exit(main())
