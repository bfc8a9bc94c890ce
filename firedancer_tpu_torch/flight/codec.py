"""fdflight frame codec: the fixed-width binary record vocabulary (copy
of the JAX package's flight/codec.py, byte for byte the same frames).

One frame = 64 little-endian bytes, the same overwrite-safety stance
as runtime/tango.py::TraceRing but for an append-only FILE instead of
a shm ring — the payload words land first and the trailing CRC seals
them, so a reader can always tell a whole frame from the torn tail a
SIGKILL mid-write leaves behind (drop, count, never propagate):

    off  sz  field
      0   4  magic      0x31464446 ("FDF1")
      4   1  kind       KIND_* below
      5   1  ver        codec version (1)
      6   2  node_id    cluster node tag (u16, [flight].node_id)
      8   8  ts_ns      utils/tempo.monotonic_ns — the ONE clock the
                        trace/prof/gui surfaces already share
     16  16  source     tile / link / SLO-target name (NUL-padded)
     32  16  name       metric / counter / series name (NUL-padded)
     48   8  value      u64 payload (delta for counters, level for
                        gauges — see the kind table)
     56   4  aux        u32 sidecar (kind-specific, below)
     60   4  crc        zlib.crc32 of bytes [0:60)

Fixed width is the point: a segment is an mmap-friendly frame array —
frame i lives at i*64 with no index, a time-range slice is a binary
search away, and the torn tail after a crash is at most one partial
frame plus whatever the filesystem zero-fills (both fail the CRC).

Kinds (the `sources` families of the [flight] section select which
get written):

    KIND_METRIC  per-tile metric slot delta (aux=1: gauge, value is
                 the level not the delta)        source family "metrics"
    KIND_HIST    per-tile stem-histogram series (wait/work/tpu sum_ns
                 deltas + work p99 level, aux=1 for levels)  "metrics"
    KIND_LINK    per-link counter delta (pub/consumed/backpressure/..
                 aggregated over consumers) + consume-latency quantile
                 levels (aux=1)                              "links"
    KIND_SLO     SLO breach/clear transition (name = "breach"|"clear",
                 value = measured value clamped to u64, aux = total
                 breaches of the target)                     "slo"
    KIND_TRACE   sampled EV_* trace event (name = event name, value =
                 record.arg, aux = etype | min(count,0xFFFF)<<16)
                                                             "trace"
    KIND_PROF    prof folded-stack digest (name = leaf frame truncated
                 to the field, value = sample-count delta)   "prof"
    KIND_MARK    run lifecycle (name = "boot"|"halt", source = the
                 topology name) — the cross-run seam markers
"""
from __future__ import annotations

import struct
import zlib

FRAME_SZ = 64
MAGIC = 0x31464446          # "FDF1" little-endian
VERSION = 1

KIND_METRIC = 1
KIND_HIST = 2
KIND_LINK = 3
KIND_SLO = 4
KIND_TRACE = 5
KIND_PROF = 6
KIND_MARK = 7

KIND_NAMES = {
    KIND_METRIC: "metric", KIND_HIST: "hist", KIND_LINK: "link",
    KIND_SLO: "slo", KIND_TRACE: "trace", KIND_PROF: "prof",
    KIND_MARK: "mark",
}

# frame body (everything but the trailing crc)
_BODY = struct.Struct("<IBBHQ16s16sQI")
assert _BODY.size == FRAME_SZ - 4
_CRC = struct.Struct("<I")
_U64_MAX = (1 << 64) - 1


def _pad16(s: str) -> bytes:
    """Name fields are fixed 16 bytes: encode, truncate at a utf-8
    boundary, NUL-pad. Truncation is lossy by design — the archive
    stores series identity, not prose."""
    b = s.encode("utf-8", "replace")[:16]
    while b:
        try:
            b.decode("utf-8")
            break
        except UnicodeDecodeError:
            b = b[:-1]
    return b.ljust(16, b"\0")


def encode_frame(kind: int, ts_ns: int, node_id: int, source: str,
                 name: str, value: int, aux: int = 0) -> bytes:
    body = _BODY.pack(MAGIC, kind & 0xFF, VERSION, node_id & 0xFFFF,
                      int(ts_ns) & _U64_MAX, _pad16(source),
                      _pad16(name), int(value) & _U64_MAX,
                      int(aux) & 0xFFFFFFFF)
    return body + _CRC.pack(zlib.crc32(body))


def decode_frame(buf: bytes) -> dict | None:
    """One 64-byte slot -> frame dict, or None when the slot is torn
    (bad magic, bad CRC, short read) — the caller counts and drops."""
    if len(buf) < FRAME_SZ:
        return None
    body, (crc,) = buf[:_BODY.size], _CRC.unpack_from(buf, _BODY.size)
    if zlib.crc32(body) != crc:
        return None
    magic, kind, ver, node, ts, source, name, value, aux = \
        _BODY.unpack(body)
    if magic != MAGIC:
        return None
    # value rides as u64 two's complement: deltas go NEGATIVE when a
    # restarted tile's counters reset, and they must re-integrate as
    # such (a huge unsigned spike would corrupt every cumulative read)
    if value >= 1 << 63:
        value -= 1 << 64
    return {
        "ts": ts, "node": node, "kind": kind,
        "kind_name": KIND_NAMES.get(kind, f"?{kind}"), "ver": ver,
        "source": source.rstrip(b"\0").decode("utf-8", "replace"),
        "name": name.rstrip(b"\0").decode("utf-8", "replace"),
        "value": value, "aux": aux,
    }


def decode_frames(buf: bytes) -> tuple[list[dict], int]:
    """A segment's raw bytes -> (frames oldest-first, dropped count).
    Dropped counts every 64-byte slot that failed validation plus a
    trailing partial slot — the torn-tail contract: detected, counted,
    never propagated."""
    out: list[dict] = []
    dropped = 0
    n = len(buf) // FRAME_SZ
    for i in range(n):
        f = decode_frame(buf[i * FRAME_SZ:(i + 1) * FRAME_SZ])
        if f is None:
            dropped += 1
        else:
            out.append(f)
    if len(buf) % FRAME_SZ:
        dropped += 1
    return out, dropped
