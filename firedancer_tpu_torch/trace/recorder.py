"""fdtrace recorder: config schema, the per-tile writer, plan helpers
(copy of the JAX package's trace/recorder.py).

The topology builder (disco/topo.py) carves one TraceRing per traced
tile next to its metric slots; TileCtx materializes a `TraceWriter`
over it (ctx.trace) — or leaves ctx.trace = None when the tile is
untraced, which is the WHOLE disabled path: every hook in the stem and
the adapters is `if tr is not None:` on a cached attribute, no
allocation, no call, no syscall.

Config — the `[trace]` topology section plus an optional per-tile
`trace` table override:

    [trace]
    enable = true          # master switch (default false)
    depth  = 2048          # records per tile ring (power of two)
    sample = 1             # record every Nth frag-scoped event
    tiles  = ["verify"]    # optional allowlist (default: every tile)

    [tile.trace]           # per-tile override, highest precedence
    enable = false         # opt this tile out (or in) individually
    depth  = 8192
    sample = 16
"""
from __future__ import annotations

import difflib

import numpy as np

from ..runtime.tango import TRACE_LINK_NONE, TraceRing
from ..utils.tempo import monotonic_ns
from . import events as ev

TRACE_DEFAULTS = {
    "enable": False,
    "depth": 2048,
    "sample": 1,
    "tiles": None,          # None = all tiles (when enabled)
}
TILE_TRACE_KEYS = ("enable", "depth", "sample")   # per-tile override


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(key, sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_trace(spec, per_tile: bool = False) -> dict:
    """Validate + default-fill a trace config table ([trace] section,
    or a tile's `trace` override with per_tile=True). Returns a plain
    JSON-able dict; raises ValueError with a did-you-mean on typos —
    the same fail-before-launch stance as supervise.normalize_policy."""
    allowed = set(TILE_TRACE_KEYS) if per_tile else set(TRACE_DEFAULTS)
    out = {} if per_tile else dict(TRACE_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"trace spec must be a table, got {spec!r}")
    unknown = set(spec) - allowed
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown trace key(s) {sorted(unknown)}"
                         + _suggest(key, allowed))
    out.update(spec)
    if "enable" in out and out["enable"] is not None:
        out["enable"] = bool(out["enable"])
    if "depth" in out:
        d = out["depth"] = int(out["depth"])
        if d <= 0 or d & (d - 1):
            raise ValueError(
                f"trace.depth must be a positive power of two, got {d}")
    if "sample" in out:
        s = out["sample"] = int(out["sample"])
        if s < 1:
            raise ValueError(f"trace.sample must be >= 1, got {s}")
    tiles = out.get("tiles")
    if tiles is not None:
        if not isinstance(tiles, (list, tuple)) or \
                not all(isinstance(t, str) for t in tiles):
            raise ValueError("trace.tiles must be a list of tile names")
        out["tiles"] = list(tiles)
    return out


def effective_trace(topo_cfg: dict, tile_name: str,
                    tile_override: dict) -> dict | None:
    """Resolve one tile's trace settings from the normalized topology
    section + the tile's own (normalized, per_tile) override. Returns
    {depth, sample} when the tile is traced, None when it is not."""
    enabled = topo_cfg["enable"] and (
        topo_cfg["tiles"] is None or tile_name in topo_cfg["tiles"])
    if "enable" in tile_override:
        enabled = bool(tile_override["enable"])
    if not enabled:
        return None
    return {"depth": int(tile_override.get("depth", topo_cfg["depth"])),
            "sample": int(tile_override.get("sample",
                                            topo_cfg["sample"]))}


def link_ids(plan: dict) -> dict[str, int]:
    """Link name -> trace link id. The id space is the SORTED link-name
    order of the plan — deterministic on both the write side (TileCtx)
    and the read side (export), with no extra plan state."""
    return {ln: i for i, ln in enumerate(sorted(plan["links"]))}


def link_names(plan: dict) -> list[str]:
    return sorted(plan["links"])


class TraceWriter:
    """The per-tile write handle: a TraceRing + the frag-event sampler.

    Lifecycle events (`event`) always record; frag-scoped events
    (`frag_batch`) record every `sample`-th frag so a high-rate pipeline
    can trade lineage completeness for ring history span. `span` stamps
    END-relative records (ts = now, arg = now - t0). (The reference's
    one-frag `frag` is left out: every hook here appends a batch.)"""

    __slots__ = ("ring", "sample", "_nfrag", "_links")

    def __init__(self, ring: TraceRing, sample: int = 1,
                 links: dict[str, int] | None = None):
        self.ring = ring
        self.sample = max(1, int(sample))
        self._nfrag = 0
        self._links = links or {}

    def link_id(self, link_name: str) -> int:
        return self._links.get(link_name, TRACE_LINK_NONE)

    def event(self, etype: int, sig: int = 0, arg: int = 0,
              link: int = TRACE_LINK_NONE, count: int = 0):
        self.ring.append(monotonic_ns(), etype, sig=sig, arg=arg,
                         link=link, count=count)

    def frag_batch(self, etype: int, sigs,
                   link: int = TRACE_LINK_NONE, ts_ns: int | None = None):
        """Sampled frag-scoped records: every `sample`-th of the running
        frag count records, whatever the batch boundaries, and the
        selected records land via ONE vectorized ring append —
        no per-frag Python on tile hot paths. Records
        in one batch share a single timestamp: the batch IS the event.
        `ts_ns` (default: now) lets a publisher stamp the records with
        the time taken BEFORE the frags became visible, so no downstream
        consume of them can carry an earlier stamp (the reference stamps
        after the publish, which drops the fastest hops from `lineage`
        and `summary`)."""
        n = len(sigs)
        if not n:
            return
        s = self.sample
        if s == 1:
            keep = np.asarray(sigs, np.uint64)
        else:
            # indices i with (nfrag + i + 1) % s == 0
            i0 = (s - 1 - self._nfrag) % s
            keep = np.asarray(sigs[i0::s], np.uint64)
        self._nfrag += n
        if len(keep):
            self.ring.append_batch(
                monotonic_ns() if ts_ns is None else ts_ns, etype, keep,
                link=link)

    def span(self, etype: int, t0_ns: int, sig: int = 0,
             link: int = TRACE_LINK_NONE, count: int = 0):
        now = monotonic_ns()
        self.ring.append(now, etype, sig=sig, arg=max(0, now - t0_ns),
                         link=link, count=count)


def writer_for(ctx_or_plan, wksp, tile_name: str) -> TraceWriter | None:
    """TraceWriter over an EXISTING tile ring (reader/supervisor side:
    plan + joined workspace), or None if the tile is untraced."""
    plan = ctx_or_plan
    spec = plan["tiles"][tile_name]
    off = spec.get("trace_off")
    if off is None:
        return None
    ring = TraceRing(wksp, off, int(spec["trace_depth"]))
    return TraceWriter(ring, sample=int(spec.get("trace_sample", 1)),
                       links=link_ids(plan))


def chaos_event(tr: TraceWriter | None, action: str, at: int = 0):
    """Record a chaos-harness fault injection (stem calls this right
    BEFORE acting, so even a `crash` leaves its own footprint in the
    flight recorder — the black-box dump then shows fault -> trip)."""
    if tr is not None:
        tr.event(ev.EV_CHAOS, arg=at,
                 count=ev.CHAOS_ACTION_IDS.get(action, 0))
