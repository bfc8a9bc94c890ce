"""Tempo: the shared monotonic-ns clock, tick calibration and the lazy
housekeeping interval (copy of the JAX package's utils/tempo.py; ref:
src/tango/tempo/fd_tempo.c). The tick source is time.perf_counter_ns,
calibrated against time.time_ns; the lazy math is the reference's
credit-return reasoning: a producer housekeeps some 10x faster than its
credit window drains."""
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


def tick_per_ns(trials: int = 9, window_s: float = 0.002) -> float:
    """Median ratio of perf_counter ticks to wallclock ns over `trials`
    sleeps of `window_s` (the joint observation of fd_tempo_tick_per_ns)."""
    obs = []
    for _ in range(max(3, trials)):
        t0 = time.perf_counter_ns()
        w0 = time.time_ns()
        time.sleep(window_s)
        t1 = time.perf_counter_ns()
        w1 = time.time_ns()
        if w1 > w0:
            obs.append((t1 - t0) / (w1 - w0))
    obs.sort()
    return obs[len(obs) // 2] if obs else 1.0


def lazy_default(cr_max: int, ns_per_frag: float = 1_000.0) -> int:
    """Housekeeping interval (ns) for a producer with cr_max credits:
    credits must return well before the window drains, so housekeep
    some 10x faster than the worst-case drain (fd_tempo_lazy_default)."""
    drain_ns = max(1.0, cr_max * ns_per_frag)
    return max(1_000, int(drain_ns / 10))


def async_min(lazy_ns: int, event_cnt: int) -> int:
    """Largest power-of-two tick spacing such that event_cnt events
    complete within about lazy_ns (fd_tempo_async_min); the caller
    jitters within [async_min, 2 * async_min)."""
    if lazy_ns <= 0 or event_cnt <= 0:
        raise ValueError("lazy_ns and event_cnt must be positive")
    per = max(1, lazy_ns // max(1, 2 * event_cnt))
    p = 1
    while p * 2 <= per:
        p *= 2
    return p
