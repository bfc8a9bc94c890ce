"""The shared monotonic-ns clock (copy of the JAX package's
utils/tempo.monotonic_ns)."""
from __future__ import annotations

import time

_MONO = None


def monotonic_ns() -> int:
    """CLOCK_MONOTONIC through the native fdtpu_ticks, the clock cnc
    heartbeats are stamped with; time.monotonic_ns (the same kernel
    clock on Linux) when the native runtime is not loadable."""
    global _MONO
    if _MONO is None:
        try:
            from ..runtime.tango import lib
            _MONO = lib.fdtpu_ticks
        except Exception:
            _MONO = time.monotonic_ns
    return int(_MONO())
