"""fdflight archive: segmented append-only frame storage + queries (copy
of the JAX package's flight/archive.py).

Write side (the recorder tile): `ArchiveWriter` appends fixed-width
frames (flight/codec.py) to the active `seg-<ts>.fdf` under the
[flight] dir, rotates at `segment_mb`, and ages out the oldest
segments once the directory exceeds `retain_mb` — the retention
budget, so the archive is bounded by construction and accumulates
ACROSS runs (each boot opens a fresh segment; KIND_MARK frames record
the seams). No fsync on the hot path: the torn-tail codec makes a
crash lose at most the tail page, never the archive.

Read side (fdflight / monitor --archive; the reference's fdgui
history panel is ROADMAP.md queue A item 9): plain
functions over the directory — every read re-validates per-frame
magic+CRC, so a segment a SIGKILL truncated mid-frame loads minus its
torn tail with an explicit dropped count.
"""
from __future__ import annotations

import json
import os

from .codec import FRAME_SZ, decode_frames, encode_frame

SEG_PREFIX = "seg-"
SEG_SUFFIX = ".fdf"
INCIDENT_PREFIX = "incident-"


def _segments(dirname: str) -> list[str]:
    """Segment paths, oldest first (names embed the open timestamp)."""
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    return [os.path.join(dirname, n) for n in sorted(names)
            if n.startswith(SEG_PREFIX) and n.endswith(SEG_SUFFIX)]


def incident_paths(dirname: str) -> list[str]:
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    return [os.path.join(dirname, n) for n in sorted(names)
            if n.startswith(INCIDENT_PREFIX) and n.endswith(".json")]


class ArchiveWriter:
    """Single-writer segment appender (the recorder tile owns the
    directory the way a tile owns its trace ring — one writer, any
    number of readers)."""

    def __init__(self, dirname: str, segment_mb: float = 8.0,
                 retain_mb: float = 64.0, node_id: int = 0):
        self.dir = dirname
        self.segment_bytes = max(FRAME_SZ, int(segment_mb * (1 << 20)))
        self.retain_bytes = max(self.segment_bytes,
                                int(retain_mb * (1 << 20)))
        self.node_id = int(node_id)
        self.frames = 0
        self.rotations = 0
        self.aged_out = 0
        self.bytes_written = 0
        os.makedirs(dirname, exist_ok=True)
        self._f = None
        self._size = 0

    def _open_segment(self, ts_ns: int):
        # the open timestamp names the segment; a pid tiebreak keeps a
        # same-ns reopen (restart storms) from clobbering history
        name = f"{SEG_PREFIX}{ts_ns:020d}-{os.getpid()}{SEG_SUFFIX}"
        self._f = open(os.path.join(self.dir, name), "ab")
        self._size = self._f.tell()

    def append(self, kind: int, ts_ns: int, source: str, name: str,
               value: int, aux: int = 0) -> bytes:
        """Append one frame; returns its encoded bytes (the recorder's
        in-memory incident tail reuses them)."""
        frame = encode_frame(kind, ts_ns, self.node_id, source, name,
                             value, aux)
        if self._f is None or self._size + FRAME_SZ > self.segment_bytes:
            self._rotate(ts_ns)
        self._f.write(frame)
        self._size += FRAME_SZ
        self.frames += 1
        self.bytes_written += FRAME_SZ
        return frame

    def _rotate(self, ts_ns: int):
        if self._f is not None:
            self._f.close()
            self.rotations += 1
        self._open_segment(ts_ns)
        self._enforce_retention()

    def _enforce_retention(self):
        segs = _segments(self.dir)
        cur = os.path.abspath(self._f.name) if self._f else None
        sizes = {}
        for p in segs:
            try:
                sizes[p] = os.path.getsize(p)
            except OSError:
                sizes[p] = 0
        total = sum(sizes.values())
        for p in segs:
            if total <= self.retain_bytes:
                break
            if os.path.abspath(p) == cur:
                break           # never delete the active segment
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= sizes[p]
            self.aged_out += 1

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


def write_atomic_json(path: str, doc: dict):
    """tmp + rename in the archive directory: the incident-bundle seal
    (and anything else durable next to the segments) either fully
    exists or does not — the utils/checkpt snapshot discipline."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------

def read_frames(dirname: str, since_ns: int | None = None,
                until_ns: int | None = None,
                kinds=None) -> tuple[list[dict], int]:
    """All archive frames in [since_ns, until_ns], oldest-first, plus
    the total torn/dropped slot count across segments. `kinds` filters
    by codec kind id set."""
    out: list[dict] = []
    dropped = 0
    for path in _segments(dirname):
        try:
            with open(path, "rb") as f:
                frames, d = decode_frames(f.read())
        except OSError:
            continue
        dropped += d
        for fr in frames:
            if since_ns is not None and fr["ts"] < since_ns:
                continue
            if until_ns is not None and fr["ts"] > until_ns:
                continue
            if kinds is not None and fr["kind"] not in kinds:
                continue
            out.append(fr)
    out.sort(key=lambda fr: fr["ts"])
    return out, dropped


def series(frames: list[dict], source: str,
           name: str) -> list[tuple[int, int]]:
    """[(ts_ns, value)] for one (source, name) series, oldest-first.
    Counter frames carry deltas; `cumulative` below re-integrates."""
    return [(fr["ts"], fr["value"]) for fr in frames
            if fr["source"] == source and fr["name"] == name]


def cumulative(points: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out, total = [], 0
    for ts, v in points:
        total += v
        out.append((ts, total))
    return out


def sources_index(frames: list[dict]) -> dict[str, set]:
    """{kind_name: {(source, name)}} — what the archive holds."""
    out: dict[str, set] = {}
    for fr in frames:
        out.setdefault(fr["kind_name"], set()).add(
            (fr["source"], fr["name"]))
    return out


def window_summary(frames: list[dict]) -> dict:
    """One window's roll-up: per-tile metric totals + rates, per-link
    counter totals — the operand of `fdflight diff` (the fdbench
    diff shape pointed at runtime history instead of BENCH jsons)."""
    from .codec import KIND_HIST, KIND_LINK, KIND_METRIC
    t0 = frames[0]["ts"] if frames else 0
    t1 = frames[-1]["ts"] if frames else 0
    wall_s = max(1e-9, (t1 - t0) / 1e9)
    metrics: dict[str, dict] = {}
    links: dict[str, dict] = {}
    for fr in frames:
        if fr["kind"] == KIND_METRIC:
            key = f"{fr['source']}.{fr['name']}"
            rec = metrics.setdefault(key, {"total": 0, "gauge": None})
            if fr["aux"] & 1:
                rec["gauge"] = fr["value"]     # level: last sample wins
            else:
                rec["total"] += fr["value"]
        elif fr["kind"] == KIND_LINK:
            rec = links.setdefault(fr["source"], {})
            if fr["aux"] & 1:
                rec[fr["name"]] = fr["value"]
            else:
                rec[fr["name"]] = rec.get(fr["name"], 0) + fr["value"]
        elif fr["kind"] == KIND_HIST and (fr["aux"] & 1):
            key = f"{fr['source']}.{fr['name']}"
            metrics.setdefault(key, {"total": 0, "gauge": None})[
                "gauge"] = fr["value"]
    for rec in metrics.values():
        rec["rate"] = round(rec["total"] / wall_s, 3)
    return {"t0_ns": t0, "t1_ns": t1, "wall_s": round(wall_s, 3),
            "metrics": metrics, "links": links}


def saturating_hop(frames: list[dict]) -> str | None:
    """The link taking the most backpressure ticks inside a window —
    the fdgui graph's saturating-hop attribution, recomputed from the
    archive (incident bundles pin it at seal time)."""
    from .codec import KIND_LINK
    bp: dict[str, int] = {}
    for fr in frames:
        if fr["kind"] == KIND_LINK and fr["name"] == "backpressure":
            bp[fr["source"]] = bp.get(fr["source"], 0) + fr["value"]
    live = {ln: v for ln, v in bp.items() if v > 0}
    return max(live, key=live.get) if live else None
