"""fdprof recorder: the [prof] schema, the shm profile region and the
host sampling profiler (copy of the JAX package's prof/recorder.py; the
region's bytes are the reference's ABI).

fdmetrics says WHICH hop saturates and fdtrace says WHEN; fdprof says
WHY: which Python frames a tile spends its time in while it waits,
works or housekeeps. Each profiled tile gets one `ProfRegion` in the
workspace (carved by disco/topo.py next to its metric slots and flight
recorder), written by a per-tile `Sampler` daemon thread that walks the
stem thread's Python stack at a configurable rate and aggregates the
folded stacks in place. Any process attached to the workspace reads the
folded stacks live or post-mortem.

Config: the `[prof]` topology section plus an optional per-tile `prof`
table override:

    [prof]
    enable = true            # master switch (default false)
    hz = 97                  # sampling rate (prime: no phase lock with
                             #   the ~100 Hz housekeeping cadence)
    slots = 256              # folded-stack table entries (power of two)
    ring = 2048              # timestamped sample ring (power of two)
    stack_depth = 16         # frames walked per sample
    tiles = ["verify"]       # optional allowlist (default: every tile)
    capture_ms = 200.0       # device-trace window length (verify tile)
    breach_capture = ["verify"]  # SLO breach -> a device capture on
                             #   these tiles (rung by the metric tile)

    [tile.prof]              # per-tile override, highest precedence
    enable = false
    hz = 29

Shm region ABI (little-endian, one writer per word class):

    header (8 u64): [0] samples  [1] dropped (table full)
                    [2] slots    [3] ring depth
                    [4] ring cursor (total samples ever ringed)
                    [5] hz (x1000, fixed point)
                    [6] capture_req   [7] capture_ack
    slot table: `slots` entries of SLOT_BYTES each:
                    u64 hash | 4 x u64 state counts (wait/work/
                    housekeep/other) | STACK_BYTES utf-8 folded stack
                    (null padded; hash == 0 means empty)
    sample ring: `ring` records of 16 B:
                    u64 ts_ns (utils/tempo.monotonic_ns, the clock of
                    fdtrace's spans) | u64 slot_idx | state << 32

capture_req / capture_ack are a cross-process doorbell for on-demand or
SLO-breach-triggered device-trace windows: a requester (the metric tile
on a breach, or `python -m firedancer_tpu_torch.prof --capture`) raises
req to ack + 1, the owning tile's housekeeping sees req > ack, runs a
bounded `torch.profiler` window (prof/device.py) and acks. ack has one
writer (the owner); req is written idempotently, so racing requesters
coalesce into one window.

Where the copy differs from the reference: the did-you-mean hint is a
few lines of difflib (the reference's lint/registry.suggest, which the
port does not import).
"""
from __future__ import annotations

import difflib
import hashlib
import sys
import threading
import time

import numpy as np

from ..utils.tempo import monotonic_ns

PROF_DEFAULTS = {
    "enable": False,
    "hz": 97.0,
    "slots": 256,
    "ring": 2048,
    "stack_depth": 16,
    "tiles": None,          # None = all tiles (when enabled)
    "capture_ms": 200.0,
    "breach_capture": [],   # tiles to device-capture on an SLO breach
}
TILE_PROF_KEYS = ("enable", "hz", "slots", "ring", "stack_depth")

PROF_HDR_U64 = 8
N_STATES = 4
STACK_BYTES = 232
SLOT_BYTES = 8 + N_STATES * 8 + STACK_BYTES      # 272, 8-aligned
RING_REC_U64 = 2

# stem-state ids (the attribution axis; export names them)
ST_WAIT, ST_WORK, ST_HOUSEKEEP, ST_OTHER = 0, 1, 2, 3
STATE_NAMES = ("wait", "work", "housekeep", "other")


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(key, sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_prof(spec, per_tile: bool = False) -> dict:
    """Validate + default-fill a prof config table ([prof] section, or
    a tile's `prof` override with per_tile=True). Returns a plain
    JSON-able dict; raises ValueError with a did-you-mean on typos —
    the same fail-before-launch stance as normalize_trace."""
    allowed = set(TILE_PROF_KEYS) if per_tile else set(PROF_DEFAULTS)
    out = {} if per_tile else dict(PROF_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"prof spec must be a table, got {spec!r}")
    unknown = set(spec) - allowed
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown prof key(s) {sorted(unknown)}"
                         + _suggest(key, allowed))
    out.update(spec)
    if "enable" in out and out["enable"] is not None:
        out["enable"] = bool(out["enable"])
    if "hz" in out:
        hz = out["hz"] = float(out["hz"])
        if not 0 < hz <= 10_000:
            raise ValueError(f"prof.hz must be in (0, 10000], got {hz}")
    for k in ("slots", "ring"):
        if k in out:
            d = out[k] = int(out[k])
            if d <= 0 or d & (d - 1):
                raise ValueError(
                    f"prof.{k} must be a positive power of two, got {d}")
    if "stack_depth" in out:
        d = out["stack_depth"] = int(out["stack_depth"])
        if d < 1:
            raise ValueError(f"prof.stack_depth must be >= 1, got {d}")
    if "capture_ms" in out:
        c = out["capture_ms"] = float(out["capture_ms"])
        if c <= 0:
            raise ValueError(f"prof.capture_ms must be > 0, got {c}")
    for k in ("tiles", "breach_capture"):
        v = out.get(k)
        if v is not None:
            if not isinstance(v, (list, tuple)) or \
                    not all(isinstance(t, str) for t in v):
                raise ValueError(f"prof.{k} must be a list of tile "
                                 f"names")
            out[k] = list(v)
    return out


def effective_prof(topo_cfg: dict, tile_name: str,
                   tile_override: dict) -> dict | None:
    """Resolve one tile's prof settings from the normalized topology
    section + the tile's own (normalized, per_tile) override. Returns
    {hz, slots, ring, stack_depth} when profiled, None when not."""
    enabled = topo_cfg["enable"] and (
        topo_cfg["tiles"] is None or tile_name in topo_cfg["tiles"])
    if "enable" in tile_override:
        enabled = bool(tile_override["enable"])
    if not enabled:
        return None
    return {k: tile_override.get(k, topo_cfg[k])
            for k in ("hz", "slots", "ring", "stack_depth")}


def stack_hash(stack: str) -> int:
    """Stable nonzero 64-bit content hash of a folded stack (stable
    across processes so a supervised respawn keeps accumulating into
    the same slots; 0 is the empty-slot sentinel)."""
    h = int.from_bytes(
        hashlib.blake2b(stack.encode(), digest_size=8).digest(),
        "little")
    return h or 1


class ProfRegion:
    """The per-tile profile region: header + folded-stack slot table +
    timestamped sample ring. Writer side is the tile's Sampler (plus
    the capture doorbell words, each single-writer); readers snapshot
    from any attached process."""

    PROBE = 16                 # linear-probe budget before `dropped`

    def __init__(self, wksp, off: int, slots: int, ring: int,
                 init: bool = False):
        for nm, d in (("slots", slots), ("ring", ring)):
            if d <= 0 or d & (d - 1):
                raise ValueError(f"prof {nm} {d} not a power of two")
        self.wksp, self.off = wksp, off
        self.slots, self.ring = slots, ring
        raw = wksp.view(off, self.footprint(slots, ring))
        self.hdr = raw[:PROF_HDR_U64 * 8].view(np.uint64)
        self._table = raw[PROF_HDR_U64 * 8:
                          PROF_HDR_U64 * 8 + slots * SLOT_BYTES]
        self._ringv = raw[PROF_HDR_U64 * 8 + slots * SLOT_BYTES:] \
            .view(np.uint64)
        if init:
            raw[:] = 0
            self.hdr[2] = slots
            self.hdr[3] = ring

    @staticmethod
    def footprint(slots: int, ring: int) -> int:
        return PROF_HDR_U64 * 8 + slots * SLOT_BYTES \
            + ring * RING_REC_U64 * 8

    @classmethod
    def create(cls, wksp, slots: int, ring: int) -> "ProfRegion":
        off = wksp.alloc(cls.footprint(slots, ring))
        return cls(wksp, off, slots, ring, init=True)

    # -- writer side --------------------------------------------------------

    def _slot_views(self, idx: int):
        base = idx * SLOT_BYTES
        s = self._table[base:base + SLOT_BYTES]
        return (s[:8].view(np.uint64), s[8:8 + N_STATES * 8]
                .view(np.uint64), s[8 + N_STATES * 8:])

    def slot_for(self, stack: str) -> int:
        """Claim-or-find the slot for a folded stack; -1 when the probe
        budget is exhausted (counted in `dropped` by record())."""
        h = stack_hash(stack)
        for i in range(self.PROBE):
            idx = (h + i) & (self.slots - 1)
            hv, _, sv = self._slot_views(idx)
            cur = int(hv[0])
            if cur == h:
                return idx
            if cur == 0:
                data = stack.encode()[:STACK_BYTES]
                sv[:len(data)] = np.frombuffer(data, np.uint8)
                hv[0] = h            # hash lands LAST: claims the slot
                return idx
        return -1

    def record(self, stack: str, state: int, ts_ns: int,
               slot_idx: int | None = None) -> int:
        """One sample: bump the stack's per-state count and append to
        the sample ring. Returns the slot index (cache it — repeat
        stacks skip the hash + probe)."""
        idx = self.slot_for(stack) if slot_idx is None else slot_idx
        hdr = self.hdr
        if idx < 0:
            # table full past the probe budget: the sample still rings
            # (cursor accounting stays exact) under the no-slot
            # sentinel, and `dropped` counts the lost attribution
            hdr[1] += 1
            ring_idx = 0xFFFFFFFF
        else:
            _, counts, _ = self._slot_views(idx)
            counts[state & (N_STATES - 1)] += 1
            ring_idx = idx
        cur = int(hdr[4])
        base = (cur & (self.ring - 1)) * RING_REC_U64
        self._ringv[base] = ts_ns & ((1 << 64) - 1)
        self._ringv[base + 1] = ring_idx | ((state & 0xFF) << 32)
        hdr[4] = cur + 1
        hdr[0] += 1
        return idx

    # -- capture doorbell ----------------------------------------------------

    @property
    def capture_req(self) -> int:
        return int(self.hdr[6])

    @property
    def capture_ack(self) -> int:
        return int(self.hdr[7])

    def request_capture(self):
        # requesters (metric tile on breach, fdprof CLI) may race each
        # other, so the request is written as an IDEMPOTENT level —
        # "one capture outstanding past ack" — not an increment whose
        # read-modify-write could lose a racing bump. Concurrent
        # requests coalesce into the one window, which is exactly what
        # a profiler wants.
        self.hdr[6] = int(self.hdr[7]) + 1

    def ack_capture(self, req: int):
        self.hdr[7] = req

    # -- reader side ---------------------------------------------------------

    @property
    def samples(self) -> int:
        return int(self.hdr[0])

    @property
    def dropped(self) -> int:
        return int(self.hdr[1])

    @property
    def ring_cursor(self) -> int:
        return int(self.hdr[4])

    def stack_at(self, idx: int) -> str | None:
        if not 0 <= idx < self.slots:      # dropped-sample sentinel
            return None
        hv, _, sv = self._slot_views(idx)
        if not int(hv[0]):
            return None
        b = bytes(sv)
        return b[:b.index(0)].decode("utf-8", "replace") if 0 in b \
            else b.decode("utf-8", "replace")

    def folded(self) -> dict[str, dict[str, int]]:
        """{folded_stack: {state_name: count}} — the aggregate table,
        live or post-mortem."""
        out: dict[str, dict[str, int]] = {}
        for idx in range(self.slots):
            hv, counts, _ = self._slot_views(idx)
            if not int(hv[0]):
                continue
            stack = self.stack_at(idx)
            out[stack] = {nm: int(counts[i])
                          for i, nm in enumerate(STATE_NAMES)
                          if int(counts[i])}
        return out

    def snapshot_ring(self) -> list[tuple[int, int, int]]:
        """[(ts_ns, slot_idx, state)] oldest-first — the timestamped
        sample stream the merged Perfetto export turns into host
        slices. Same overwrite-oldest/cursor accounting as TraceRing."""
        cur = self.ring_cursor
        n = min(cur, self.ring)
        out = []
        for k in range(cur - n, cur):
            base = (k & (self.ring - 1)) * RING_REC_U64
            meta = int(self._ringv[base + 1])
            out.append((int(self._ringv[base]),
                        meta & 0xFFFFFFFF, (meta >> 32) & 0xFF))
        return out


class ProfState:
    """The stem -> sampler attribution channel: two plain attributes
    the run loop stores into (GIL-atomic) and the sampler thread reads.
    Kept deliberately tiny — when profiling is off the stem never
    touches it (the None-check contract fdtrace set)."""

    __slots__ = ("state", "link")

    def __init__(self):
        self.state = ST_OTHER
        self.link: str | None = None


class Sampler:
    """Daemon-thread statistical profiler over ONE target thread (the
    stem loop). Each tick reads the target's current Python frame via
    sys._current_frames, folds it root-first (`file:func;...`), tags it
    with the stem state + active in-link from `ProfState`, and records
    into the shm region. A per-process stack->slot cache keeps the
    steady-state tick to one dict hit + three shm stores."""

    def __init__(self, region: ProfRegion, hz: float,
                 target_ident: int, state: ProfState,
                 stack_depth: int = 16):
        self.region = region
        self.hz = float(hz)
        self.ident = target_ident
        self.state = state
        self.stack_depth = int(stack_depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cache: dict[str, int] = {}
        region.hdr[5] = int(self.hz * 1000)

    def sample_once(self, frame=None) -> str | None:
        """One sample (the thread loop body; separable for tests).
        Returns the folded stack recorded, or None if the target
        thread had no frame."""
        if frame is None:
            frame = sys._current_frames().get(self.ident)
            if frame is None:
                return None
        parts = []
        f, d = frame, 0
        while f is not None and d < self.stack_depth:
            code = f.f_code
            fn = code.co_filename.rsplit("/", 1)[-1]
            if fn.endswith(".py"):
                fn = fn[:-3]
            parts.append(f"{fn}:{code.co_name}")
            f = f.f_back
            d += 1
        parts.reverse()
        st = self.state.state
        link = self.state.link
        if link and st == ST_WORK:
            # active in-link as the flamegraph root under the work
            # state: "which link's traffic was I serving"
            parts.insert(0, f"[{link}]")
        stack = ";".join(parts)
        idx = self._cache.get(stack)
        idx2 = self.region.record(stack, st, monotonic_ns(),
                                  slot_idx=idx)
        if idx is None and idx2 >= 0:
            self._cache[stack] = idx2
        return stack

    def _loop(self):
        period = 1.0 / self.hz
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self.sample_once()
            except Exception:      # noqa: BLE001 — the profiler must
                pass               # never take the tile down with it
            dt = time.perf_counter() - t0
            self._stop.wait(max(1e-4, period - dt))

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="fdprof-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None


def region_for(plan: dict, wksp, tile_name: str) -> ProfRegion | None:
    """ProfRegion over an EXISTING tile region (tile/reader side:
    plan + joined workspace), or None if the tile is unprofiled."""
    spec = plan["tiles"][tile_name]
    off = spec.get("prof_off")
    if off is None:
        return None
    return ProfRegion(wksp, off, int(spec["prof_slots"]),
                      int(spec["prof_ring"]))
