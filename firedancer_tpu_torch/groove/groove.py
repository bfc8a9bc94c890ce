"""groove — disk-backed mmap cold store with size-class allocation (copy
of the JAX package's groove/groove.py).

Re-expression of the reference's groove (ref: src/groove/fd_groove.h:
1-13 — "meta map + volume pool + size-class data heap"; data layout
fd_groove_data.h). Role in the storage stack: funk is the hot
fork-aware KV, vinyl is the log-structured crash-safe stream, groove
is the COLD random-access store — big account payloads that left the
working set but must stay addressable.

Design (not a C port):

  * volumes: fixed-size mmap'd files (`vol-NNNN.groove`) created on
    demand in the store directory — the reference's volume pool.
  * size classes: powers of two from MIN_CLASS to MAX_CLASS; an
    object lives in the smallest class that fits header+payload+crc.
    Per-class free lists make delete->put reuse O(1).
  * records are self-describing on disk: magic, state byte
    (LIVE/DEAD), class, key, payload length, crc32 trailer — so
    open() rebuilds the meta map and the free lists by scanning
    volumes (crash recovery = the scan; a torn write fails its crc
    and is reclaimed as free space).
  * reads are zero-copy memoryviews over the mmap; callers copy if
    they hold the data across a delete (documented borrow, same
    discipline as accdb.peek).

Single-writer / multi-reader per process; cross-process sharing goes
through the filesystem (a fresh open sees every durable record).
"""
from __future__ import annotations

import mmap
import os
import struct
import zlib

MAGIC = 0x67726F32          # "gro2" — v2 layout (lsn in the header)
MAGIC_V1 = 0x67726F6F       # pre-lsn layout: refused loudly, never
#                             silently misread as torn (r4 review)
ST_LIVE = 1
ST_DEAD = 2

MIN_CLASS = 7               # 128 B
MAX_CLASS = 24              # 16 MiB object ceiling
VOLUME_SZ = 1 << 26         # 64 MiB volumes

_HDR = "<IBBH32sIQ"         # magic, state, class, rsvd, key,
#                             data_len, lsn (monotone write sequence —
#                             the duplicate-LIVE tiebreak on recovery)
_HDR_SZ = struct.calcsize(_HDR)
_CRC_SZ = 4


class GrooveError(RuntimeError):
    pass


def _class_for(payload_len: int) -> int:
    need = _HDR_SZ + payload_len + _CRC_SZ
    c = MIN_CLASS
    while (1 << c) < need:
        c += 1
        if c > MAX_CLASS:
            raise GrooveError(f"object too large: {payload_len}")
    return c


class _Volume:
    def __init__(self, path: str, create: bool):
        self.path = path
        if create:
            with open(path, "wb") as f:
                f.truncate(VOLUME_SZ)
        self.f = open(path, "r+b")
        self.mm = mmap.mmap(self.f.fileno(), VOLUME_SZ)
        self.cursor = 0          # bump frontier (recovered on scan)

    def close(self):
        self.mm.flush()
        self.mm.close()
        self.f.close()


class GrooveStore:
    """put/get/delete of 32-byte-keyed blobs over mmap'd volumes."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.vols: list[_Volume] = []
        self.meta: dict[bytes, tuple[int, int]] = {}   # key -> (vol, off)
        self.free: dict[int, list[tuple[int, int]]] = {}
        self._lsn = 0
        self._live_lsn: dict[bytes, int] = {}
        self.stats = {"puts": 0, "gets": 0, "deletes": 0,
                      "reused": 0, "torn_reclaimed": 0,
                      "dup_reconciled": 0}
        for name in sorted(os.listdir(directory)):
            if name.startswith("vol-") and name.endswith(".groove"):
                self._scan(_Volume(os.path.join(directory, name),
                                   create=False))

    # -- recovery scan ------------------------------------------------------

    def _scan(self, vol: _Volume):
        vid = len(self.vols)
        self.vols.append(vol)
        off = 0
        while off + _HDR_SZ <= VOLUME_SZ:
            magic, state, cls, _, key, dlen, lsn = struct.unpack_from(
                _HDR, vol.mm, off)
            if magic == MAGIC_V1:
                raise GrooveError(
                    f"{vol.path}: v1 groove volume (pre-lsn layout) — "
                    f"refusing to misread it; migrate or remove")
            if magic != MAGIC:
                break                         # frontier reached
            if not MIN_CLASS <= cls <= MAX_CLASS:
                break                         # corrupt header: stop at
                # the frontier rather than walk garbage (records past a
                # corrupt class byte are unreachable anyway — the slot
                # stride is unknown)
            sz = 1 << cls
            # dlen bounds-check BEFORE the crc read: a corrupt length
            # must reclaim the slot, not crash open() (the recovery
            # contract)
            if state == ST_LIVE and _HDR_SZ + dlen + _CRC_SZ <= sz \
                    and off + sz <= VOLUME_SZ:
                end = off + _HDR_SZ + dlen
                crc, = struct.unpack_from("<I", vol.mm, end)
                if zlib.crc32(vol.mm[off + _HDR_SZ:end]) == crc:
                    self._lsn = max(self._lsn, lsn)
                    prev = self.meta.get(key)
                    if prev is not None:
                        # crash window duplicate (put() died between
                        # writing the new copy and killing the old):
                        # higher lsn wins, the loser is tombstoned so
                        # a later delete cannot be resurrected
                        self.stats["dup_reconciled"] += 1
                        if lsn > self._live_lsn[key]:
                            self._kill(*prev)
                            self.meta[key] = (vid, off)
                            self._live_lsn[key] = lsn
                        else:
                            self._kill(vid, off)
                    else:
                        self.meta[key] = (vid, off)
                        self._live_lsn[key] = lsn
                else:                         # torn write: reclaim
                    self.stats["torn_reclaimed"] += 1
                    self.free.setdefault(cls, []).append((vid, off))
            elif state == ST_LIVE:            # corrupt dlen: reclaim
                self.stats["torn_reclaimed"] += 1
                self.free.setdefault(cls, []).append((vid, off))
            else:
                self.free.setdefault(cls, []).append((vid, off))
            off += sz
        vol.cursor = off

    # -- allocation ---------------------------------------------------------

    def _alloc(self, cls: int) -> tuple[int, int]:
        fl = self.free.get(cls)
        if fl:
            self.stats["reused"] += 1
            return fl.pop()
        sz = 1 << cls
        for vid, vol in enumerate(self.vols):
            if vol.cursor + sz <= VOLUME_SZ:
                off = vol.cursor
                vol.cursor += sz
                return (vid, off)
        path = os.path.join(self.dir, f"vol-{len(self.vols):04d}.groove")
        vol = _Volume(path, create=True)
        self.vols.append(vol)
        vol.cursor = sz
        return (len(self.vols) - 1, 0)

    # -- operations ---------------------------------------------------------

    def put(self, key: bytes, data: bytes):
        """Insert or overwrite. Overwrite writes the new copy first,
        then tombstones the old; a crash between the two leaves BOTH
        live and the recovery scan keeps the higher-lsn copy (the new
        one when its crc completed, otherwise the old) — never a torn
        value, never a resurrectable duplicate."""
        if len(key) != 32:
            raise GrooveError("key must be 32 bytes")
        cls = _class_for(len(data))
        vid, off = self._alloc(cls)
        mm = self.vols[vid].mm
        self._lsn += 1
        struct.pack_into(_HDR, mm, off, MAGIC, ST_LIVE, cls, 0, key,
                         len(data), self._lsn)
        end = off + _HDR_SZ
        mm[end:end + len(data)] = data
        struct.pack_into("<I", mm, end + len(data),
                         zlib.crc32(data))
        old = self.meta.get(key)
        self.meta[key] = (vid, off)
        self._live_lsn[key] = self._lsn
        if old is not None:
            self._kill(*old)
        self.stats["puts"] += 1

    def get(self, key: bytes) -> memoryview | None:
        loc = self.meta.get(key)
        if loc is None:
            return None
        vid, off = loc
        mm = self.vols[vid].mm
        dlen = struct.unpack_from(_HDR, mm, off)[5]
        self.stats["gets"] += 1
        return memoryview(mm)[off + _HDR_SZ:off + _HDR_SZ + dlen]

    def delete(self, key: bytes) -> bool:
        loc = self.meta.pop(key, None)
        self._live_lsn.pop(key, None)
        if loc is None:
            return False
        self._kill(*loc)
        self.stats["deletes"] += 1
        return True

    def _kill(self, vid: int, off: int):
        mm = self.vols[vid].mm
        cls = mm[off + 5]
        mm[off + 4] = ST_DEAD
        self.free.setdefault(cls, []).append((vid, off))

    def flush(self):
        for v in self.vols:
            v.mm.flush()

    def close(self):
        for v in self.vols:
            v.close()
        self.vols.clear()
        self.meta.clear()

    def __len__(self):
        return len(self.meta)
