"""Archiver: record / replay frag streams for deterministic re-driving
(copy of the JAX package's tiles/archiver.py: ArchiveWriter and
ArchivePlayback; ref: src/disco/archiver/fd_archiver.h:1-20 — writer +
playback tiles capture raw tango streams so a tile graph can be
re-driven exactly). A file either package writes reads through the
other's CheckptReader.

File format: checkpoint frames (utils/checkpt.py — integrity trailer
included), one frame per frag:

    u64 seq | u64 sig | u16 ctl | u32 sz | payload

Playback republishes the captured payload/sig/ctl sequence onto a link
at full speed (credit-gated), preserving ordering and message framing
(SOM/EOM multi-frag streams replay exactly)."""
from __future__ import annotations

import struct


class ArchiveWriter:
    """archiver-writer core: consume one link, append frags to a file."""

    def __init__(self, in_ring, path: str):
        from ..utils.checkpt import CheckptWriter
        self.ring = in_ring
        self.fp = open(path, "wb")
        self.w = CheckptWriter(self.fp, compress=True)
        self.seq = 0
        self.metrics = {"frags": 0, "bytes": 0, "overruns": 0}
        self._closed = False

    def poll_once(self) -> int:
        got = 0
        while got < 64:
            rc, frag = self.ring.consume(self.seq)
            if rc == 1:
                return got
            if rc == -1:
                # lapped: resync to the oldest plausibly-live seq (the
                # native gather's recovery, fdtpu.cc) — advancing one
                # seq at a time can never catch a fast producer
                prod = self.ring.seq
                depth = self.ring.depth
                resync = prod - depth if prod > depth else 0
                self.metrics["overruns"] += max(1, resync - self.seq)
                self.seq = max(self.seq + 1, resync)
                got += 1
                continue
            payload = bytes(self.ring.payload(frag))
            rc2, check = self.ring.consume(self.seq)
            if rc2 != 0 or check.seq != frag.seq:
                continue              # torn read: retry the slot
            self.w.frame(struct.pack("<QQHI", frag.seq, frag.sig,
                                     frag.ctl, frag.sz)
                         + payload[:frag.sz])
            self.metrics["frags"] += 1
            self.metrics["bytes"] += frag.sz
            self.seq += 1
            got += 1
        return got

    def close(self):
        if not self._closed:
            self._closed = True
            self.w.fini()
            self.fp.close()


class ArchivePlayback:
    """playback core: republish a captured stream onto a link."""

    def __init__(self, path: str, out_ring, out_fseqs):
        from ..utils.checkpt import CheckptReader
        self.fp = open(path, "rb")
        self._frames = CheckptReader(self.fp).frames()
        self.out = out_ring
        self.fseqs = out_fseqs or []
        self._pending = None
        self.metrics = {"frags": 0, "bytes": 0, "done": 0,
                        "backpressure": 0}

    def poll_once(self) -> int:
        if self.metrics["done"]:
            return 0
        n = 0
        while n < 64:
            if self._pending is None:
                try:
                    self._pending = next(self._frames)
                except StopIteration:
                    self.metrics["done"] = 1
                    self.fp.close()
                    break
            if self.fseqs and self.out.credits(self.fseqs) <= 0:
                self.metrics["backpressure"] += 1
                return n
            frame = self._pending
            seq, sig, ctl, sz = struct.unpack_from("<QQHI", frame, 0)
            self.out.publish(frame[22:22 + sz], sig=sig, ctl=ctl)
            self._pending = None
            self.metrics["frags"] += 1
            self.metrics["bytes"] += sz
            n += 1
        return n
