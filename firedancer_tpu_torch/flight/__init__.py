"""fdflight: the durable flight-data archive (copy of the JAX package's
flight/__init__.py).

Every observability surface of the port — fdmetrics counters, fdtrace
rings, fdprof samples, the SLO engine's breach dumps — is
shared-memory-resident with overwrite-oldest semantics, and so answers
"what is happening" but never "what happened 30 seconds ago" once the
rings wrap or the workspace is unlinked. This package is a bounded,
append-only, crash-tolerant on-disk archive of the shm observability
plane, drained by a reader-side recorder tile (disco/tiles.py
FlightAdapter: the writer tiles pay nothing) and queried post-mortem by
`python -m firedancer_tpu_torch.flight` and `python -m
firedancer_tpu_torch.disco.monitor --archive`.

Config — the `[flight]` topology section, validated at config load and
at topo.build:

    [flight]
    dir       = "/tmp/fdtt-flight/fdtt"   # archive directory
    segment_mb = 8.0       # rotate the active segment at this size
    retain_mb  = 64.0      # age out oldest segments beyond this total
    hz         = 4.0       # recorder drain cadence
    sources    = ["metrics", "links", "slo", "trace", "prof"]
    incident_window_s = 5.0   # +/- bundle window around an SLO breach
    node_id    = 0         # stamped into every frame (cluster merge)

On-disk format: fixed-width 64-byte binary frames (flight/codec.py —
monotonic_ns | node_id | kind | source | name | value), segments named
`seg-*.fdf` under `dir` (flight/archive.py), incident bundles sealed
atomically next to them (flight/recorder.py). Torn tail frames from a
SIGKILL mid-write are detected by per-frame magic+CRC and dropped on
read, never propagated. Frames, segments and bundles are the
reference's byte for byte: either package reads the other's archive.

Where the copy differs from the reference: the default `dir` follows
the port's prefix (/tmp/fdtt-flight/..., where the reference writes
/tmp/fdtpu-flight/...; ROADMAP.md C), and the did-you-mean hint is the
port's difflib one (trace/recorder.py), not lint/registry.suggest
(fdlint's bad-flight rule is ROADMAP.md queue A item 20).
"""
from __future__ import annotations

from ..trace.recorder import _suggest

FLIGHT_DEFAULTS = {
    "dir": "/tmp/fdtt-flight/default",
    "segment_mb": 8.0,
    "retain_mb": 64.0,
    "hz": 4.0,
    "sources": None,        # None = every source family
    "incident_window_s": 5.0,
    "node_id": 0,
}

# the frame-source families the recorder can drain (codec kinds map
# onto these; `sources` selects a subset)
FLIGHT_SOURCES = ("metrics", "links", "slo", "trace", "prof")


def normalize_flight(spec) -> dict:
    """Validate + default-fill a `[flight]` table. Returns a plain
    JSON-able dict; raises ValueError with a did-you-mean on typos —
    the same fail-before-launch stance as normalize_trace."""
    out = dict(FLIGHT_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"flight spec must be a table, got {spec!r}")
    unknown = set(spec) - set(FLIGHT_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown flight key(s) {sorted(unknown)}"
                         + _suggest(key, FLIGHT_DEFAULTS))
    out.update(spec)
    d = out["dir"]
    if not isinstance(d, str) or not d:
        raise ValueError(f"flight.dir must be a non-empty path, got {d!r}")
    seg = out["segment_mb"] = float(out["segment_mb"])
    if seg <= 0:
        raise ValueError(f"flight.segment_mb must be > 0, got {seg}")
    ret = out["retain_mb"] = float(out["retain_mb"])
    if ret < seg:
        raise ValueError(f"flight.retain_mb ({ret}) must be >= "
                         f"segment_mb ({seg}) — retention below one "
                         f"segment keeps no history at all")
    hz = out["hz"] = float(out["hz"])
    if not 0 < hz <= 1000:
        raise ValueError(f"flight.hz must be in (0, 1000], got {hz}")
    win = out["incident_window_s"] = float(out["incident_window_s"])
    if win < 0:
        raise ValueError(
            f"flight.incident_window_s must be >= 0, got {win}")
    node = out["node_id"] = int(out["node_id"])
    if not 0 <= node <= 0xFFFF:
        raise ValueError(
            f"flight.node_id must fit u16 (0..65535), got {node}")
    srcs = out.get("sources")
    if srcs is not None:
        if not isinstance(srcs, (list, tuple)) or \
                not all(isinstance(s, str) for s in srcs):
            raise ValueError("flight.sources must be a list of source "
                             f"names from {list(FLIGHT_SOURCES)}")
        bad = sorted(set(srcs) - set(FLIGHT_SOURCES))
        if bad:
            raise ValueError(
                f"unknown flight source(s) {bad}"
                + _suggest(bad[0], FLIGHT_SOURCES))
        out["sources"] = list(srcs)
    return out


def effective_sources(cfg: dict) -> set:
    """The drained source families of a normalized [flight] table."""
    srcs = cfg.get("sources")
    return set(FLIGHT_SOURCES if srcs is None else srcs)
