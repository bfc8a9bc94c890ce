"""Tile sandbox: privilege + resource hardening at tile boot (copy of
the JAX package's utils/sandbox.py).

The reference sandboxes every tile with seccomp-bpf allowlists, a
pid/net namespace, dropped capabilities, and RLIMIT caps
(ref: src/util/sandbox/fd_sandbox.h). A Python tile process can't
install a meaningful seccomp allowlist (the interpreter itself needs a
wide syscall surface), so this module implements the enforceable
subset — the defense-in-depth layers that do translate:

  * PR_SET_NO_NEW_PRIVS: no setuid/fscaps escalation ever again
  * RLIMIT_NOFILE / RLIMIT_AS / RLIMIT_CORE caps
  * close every fd above the tile's declared set (inherited fds are
    the classic sandbox escape surface)

Documented divergence: no syscall filtering, no namespaces — those
need the native launcher (the C++ runtime's future job)."""
from __future__ import annotations

import ctypes
import os
import resource

PR_SET_NO_NEW_PRIVS = 38


def no_new_privs() -> bool:
    """prctl(PR_SET_NO_NEW_PRIVS, 1) — irreversible for this process
    tree. Returns True on success."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) == 0
    except Exception:
        return False


def apply(max_files: int = 256, max_mem_gb: float = 0.0,
          keep_fds: tuple = (0, 1, 2), close_high_fds: bool = False):
    """Harden the calling tile process. max_mem_gb 0 = no address-space
    cap (device-backed tiles map large arenas). close_high_fds is
    OPT-IN: it closes fds out from under live objects (mmap'd
    workspace, sockets, device handles) and is only safe before any of
    those exist. Returns a report dict for the tile's boot log."""
    report = {"no_new_privs": no_new_privs()}
    try:
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        report["core"] = 0
    except Exception:
        report["core"] = -1
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        lim = min(max_files, hard if hard > 0 else max_files)
        resource.setrlimit(resource.RLIMIT_NOFILE, (lim, lim))
        report["nofile"] = lim
    except Exception:
        report["nofile"] = -1
    if max_mem_gb > 0:
        try:
            cap = int(max_mem_gb * (1 << 30))
            resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
            report["as_bytes"] = cap
        except Exception:
            report["as_bytes"] = -1
    if close_high_fds:
        # everything above the declared set is an inherited leak
        keep = set(keep_fds)
        try:
            maxfd = max((int(f) for f in os.listdir("/proc/self/fd")),
                        default=3)
        except Exception:
            maxfd = 1024
        closed = 0
        for fd in range(3, maxfd + 1):
            if fd in keep:
                continue
            try:
                os.close(fd)
                closed += 1
            except OSError:
                pass
        report["closed_fds"] = closed
    return report
