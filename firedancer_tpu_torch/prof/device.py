"""fdprof device side: bounded `torch.profiler` windows and kernel-load
events, driven by the shm capture doorbell (the port's counterpart of
the JAX package's prof/device.py, whose windows are `jax.profiler`
traces).

The host sampler (recorder.py) explains Python time; which kernels ran,
for how long, and how long the card sat idle between them belong to the
device profiler. A capture is a bounded window: the owning tile's
housekeeping sees `capture_req > capture_ack` on its ProfRegion (raised
by the metric tile on an SLO breach, or by `python -m
firedancer_tpu_torch.prof --capture`), starts a
`torch.profiler.profile(activities=[CPU, CUDA])` (CPU only for a tile on
the CPU), lets the normal poll loop run the window out, then stops it in
a later pass, writes the Chrome trace under `trace_dir`, writes a JSON
manifest next to the supervisor black boxes, stamps an EV_PROF_CAPTURE
span into the flight recorder and acks. A profiler that fails still
leaves the manifest (ok false, with the error): a breach-triggered drill
leaves an artifact either way, and the tile runs on.

The manifest has the reference's keys (topology, tile, req, t0_ns,
t1_ns, window_ms, ok, trace_dir, error) and:

    kernels            {name: {"launches": n, "us": summed µs}}, from
                       the trace's "kernel" events (CUPTI's records)
    device_busy_ms     the union of the kernel intervals in the window
    device_busy_share  that union over the recorded window
    recorded_ms        the recorded window: from the moment `start()`
                       returned to the stop (the share's denominator;
                       CUPTI's start-up, `start_ms`, is outside it)
    start_ms, stop_ms  what `start()` and the stop (a device sync, then
                       `stop()`) cost the poll loop
    warm_ms            the boot's one-time profiler start-up, paid
                       before RUN when the tile warms its capture (0
                       otherwise: then the first window's start pays it)
    trace_file         the Chrome trace
    kernel_events      [[name, ts_ns, dur_ns], ...] on the
                       utils/tempo.monotonic_ns clock (at most
                       KERNEL_EVENTS_MAX), aligned through a
                       `record_function` mark taken at a known
                       monotonic_ns, so prof/export.merged_chrome puts
                       them on one timeline with fdtrace's spans

Kernel-load events ride the same housekeeping pass (CompileWatch): the
port has no jit, so a "compile" is a kernel entry point this process
loaded or built through ops/_build.py's `lib` (its `_libs` table). The
verify tile's warmup loads its entry points at boot; one loaded later
is a load the steady state should not see. Each leaves an EV_COMPILE
trace record and refreshes the compile manifest.
"""
from __future__ import annotations

import json
import os
import tempfile

from ..utils.tempo import monotonic_ns

KERNEL_EVENTS_MAX = 8192
MARK = "fdtt_capture_mark"


def capture_manifest_path(topology: str, tile: str) -> str:
    return f"/dev/shm/fdtt_{topology}.prof.{tile}.capture.json"


def compile_manifest_path(topology: str, tile: str) -> str:
    return f"/dev/shm/fdtt_{topology}.prof.{tile}.compile.json"


def trace_dir(topology: str, tile: str) -> str:
    # the profiler's trace goes to the temporary directory, not
    # /dev/shm: only the small manifest lives with the black boxes
    return os.path.join(tempfile.gettempdir(),
                        f"fdtt_prof_{topology}_{tile}")


def request_capture(plan: dict, wksp, tile: str) -> bool:
    """Ring the capture doorbell of a profiled tile (the requester side:
    the metric tile on a breach, or the prof CLI). False if the tile is
    not profiled."""
    from .recorder import region_for
    region = region_for(plan, wksp, tile)
    if region is None:
        return False
    region.request_capture()
    return True


def busy_union_ns(intervals) -> int:
    """Length of the union of [t0, t1) intervals (ns)."""
    total, end = 0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def read_trace(path: str, mark_ns: int, t_rec_ns: int,
               t1_ns: int) -> dict:
    """The kernel summary of one Chrome trace: kernels, kernel_events on
    the monotonic_ns clock, device_busy_ms and device_busy_share over
    [t_rec_ns, t1_ns]. The trace's clock is tied to monotonic_ns by the
    MARK annotation taken at `mark_ns`; a trace without it raises
    ValueError (the capture's manifest then reads ok: false)."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    anchor = None
    for e in evs:
        if e.get("name") == MARK and e.get("ph") == "X" \
                and e.get("cat") == "user_annotation":
            anchor = float(e["ts"])
            break
    if anchor is None:
        raise ValueError(f"{path}: no {MARK} annotation to tie the "
                         "trace's clock to monotonic_ns")
    kernels: dict = {}
    spans = []
    for e in evs:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        dur_us = float(e.get("dur", 0.0))
        k = kernels.setdefault(e["name"], {"launches": 0, "us": 0.0})
        k["launches"] += 1
        k["us"] += dur_us
        t0 = mark_ns + int((float(e["ts"]) - anchor) * 1e3)
        spans.append((e["name"], t0, int(dur_us * 1e3)))
    spans.sort(key=lambda s: s[1])
    busy = busy_union_ns(
        (max(t0, t_rec_ns), min(t0 + d, t1_ns)) for _, t0, d in spans
        if t0 + d > t_rec_ns and t0 < t1_ns)
    window = max(1, t1_ns - t_rec_ns)
    return {"kernels": kernels, "device_busy_ms": busy / 1e6,
            "device_busy_share": busy / window, "clock": "mark",
            "kernel_events": [list(s) for s in spans[:KERNEL_EVENTS_MAX]]}


class DeviceCapture:
    """The owning tile's capture state machine, polled from its
    housekeeping, never from the hot loop:

        poll() -> the manifest path when a window just closed, else None

    The window's length is the plan's [prof] capture_ms, counted from
    the moment the profiler records; it runs out across housekeeping
    passes, so the poll loop keeps driving the card while the profiler
    records it. `device` is the tile's: "cpu" records CPU activities
    only."""

    def __init__(self, plan: dict, tile: str, region, trace=None,
                 device: str = "cuda", warm: bool = False):
        self.plan, self.tile, self.region = plan, tile, region
        self.trace = trace
        self.device = str(device)
        self.topology = plan.get("topology", "?")
        self.window_ms = float(
            (plan.get("prof") or {}).get("capture_ms", 200.0))
        self._active: dict | None = None
        self.captures = 0
        # CUPTI's start-up: the first window of a process took 11.7 s to
        # start on an H100 (chip_smoke.py's phase 21), a later one 5 ms.
        # `warm` pays it once here, at boot, with an empty window, so
        # that no capture stalls the poll loop for it; warm_ms records
        # the cost (every manifest carries it)
        self.warm_ms = 0.0
        if warm:
            self.warm_ms = self._warm()

    def _cuda(self) -> bool:
        return self.device.startswith("cuda")

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self._cuda():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _warm(self) -> float:
        from torch.profiler import profile
        t0 = monotonic_ns()
        prof = profile(activities=self._activities())
        prof.start()
        prof.stop()
        return (monotonic_ns() - t0) / 1e6

    def _start(self, req: int):
        t0 = monotonic_ns()
        d = trace_dir(self.topology, self.tile)
        act = {"req": req, "t0": t0, "dir": d, "err": None, "prof": None,
               "mark": None}
        try:
            os.makedirs(d, exist_ok=True)
            import torch
            from torch.profiler import profile
            prof = profile(activities=self._activities())
            prof.start()
            act["prof"] = prof
            with torch.profiler.record_function(MARK):
                act["mark"] = monotonic_ns()
        except Exception as e:     # noqa: BLE001 — manifest either way
            act["err"] = f"{e!r}"[:200]
        act["t_rec"] = monotonic_ns()
        act["start_ms"] = (act["t_rec"] - t0) / 1e6
        act["deadline"] = act["t_rec"] + int(self.window_ms * 1e6)
        self._active = act

    def _stop(self) -> str | None:
        act, self._active = self._active, None
        t_stop = monotonic_ns()
        t1 = t_stop
        summary: dict = {}
        trace_file = None
        if act["err"] is None:
            try:
                if self._cuda():
                    import torch
                    torch.cuda.synchronize(self.device)
                t1 = monotonic_ns()
                act["prof"].stop()
                trace_file = os.path.join(act["dir"],
                                          f"capture_{act['req']}.json")
                act["prof"].export_chrome_trace(trace_file)
                summary = read_trace(trace_file, act["mark"],
                                     act["t_rec"], t1)
            except Exception as e:  # noqa: BLE001
                act["err"] = f"{e!r}"[:200]
        doc = {
            "topology": self.topology,
            "tile": self.tile,
            "req": act["req"],
            "t0_ns": act["t0"],
            "t1_ns": t1,
            "window_ms": self.window_ms,
            "ok": act["err"] is None,
            "trace_dir": act["dir"] if act["err"] is None else None,
            "error": act["err"],
            "device": self.device,
            "recorded_ms": (t1 - act["t_rec"]) / 1e6,
            "start_ms": act["start_ms"],
            "warm_ms": self.warm_ms,
            "stop_ms": (monotonic_ns() - t_stop) / 1e6,
            "trace_file": trace_file,
            "kernels": summary.get("kernels", {}),
            "device_busy_ms": summary.get("device_busy_ms", 0.0),
            "device_busy_share": summary.get("device_busy_share", 0.0),
            "clock": summary.get("clock"),
            "kernel_events": summary.get("kernel_events", []),
        }
        path = capture_manifest_path(self.topology, self.tile)
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            path = None
        if self.trace is not None:
            from ..trace.events import EV_PROF_CAPTURE
            self.trace.span(EV_PROF_CAPTURE, act["t0"], count=act["req"])
        self.region.ack_capture(act["req"])
        self.captures += 1
        return path

    def poll(self) -> str | None:
        """One housekeeping pass; the manifest path when a window just
        closed."""
        if self._active is not None:
            if monotonic_ns() >= self._active["deadline"]:
                return self._stop()
            return None
        req = self.region.capture_req
        if req > self.region.capture_ack:
            self._start(req)
        return None

    def flush(self):
        """Halt path: close an open window so the ack never dangles."""
        if self._active is not None:
            self._stop()


class CompileWatch:
    """Kernel-load events: detects growth of `compiles_fn()` between
    housekeeping passes, stamps EV_COMPILE into the flight recorder
    (arg: `mem_fn()`, the device bytes in use; count: the new count)
    and keeps the compile manifest fresh when `manifest` (a profiled
    tile). The first pass registers the boot's loads as event 1;
    `cache_miss` counts the loads past `boot` (the reference's is the
    compiles past one, the warmup's single jit compile)."""

    def __init__(self, plan: dict, tile: str, compiles_fn, trace=None,
                 mem_fn=None, manifest: bool = True, boot: int = 1):
        self.topology = plan.get("topology", "?")
        self.tile = tile
        self._compiles = compiles_fn
        self._mem = mem_fn or (lambda: 0)
        self.trace = trace
        self.manifest = manifest
        self.boot = boot
        self.last = 0
        self.events = 0

    def poll(self) -> int | None:
        """The new count when it grew, else None."""
        cur = self._compiles()
        if cur <= self.last:
            return None
        self.last = cur
        self.events += 1
        if self.trace is not None:
            from ..trace.events import EV_COMPILE
            self.trace.event(EV_COMPILE, arg=self._mem(), count=cur)
        if not self.manifest:
            return cur
        doc = {
            "topology": self.topology,
            "tile": self.tile,
            "compiles": cur,
            "cache_miss": max(0, cur - self.boot),
            "device_mem_bytes": self._mem(),
            "ts_ns": monotonic_ns(),
        }
        try:
            with open(compile_manifest_path(self.topology, self.tile),
                      "w") as f:
                json.dump(doc, f)
        except OSError:
            pass
        return cur


def kernel_loads() -> int:
    """Kernel entry points this process has loaded or built through
    ops/_build.py's `lib`: the port's compile count."""
    from ..ops import _build
    return len(_build._libs)
