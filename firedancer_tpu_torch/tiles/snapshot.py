"""Snapshot restore pipeline tiles: loader -> decompress -> inserter
over rings (copy of the JAX package's tiles/snapshot.py:
SNAPSHOT_DEFAULTS, normalize_snapshot, state_fingerprint, SnapLoader
with its chaos seams, SnapInserter, SnapDecompress and ArchiveInserter).

The reference's cold-start pipeline streams a snapshot through
dedicated tiles (snapct/snapld -> snapdc -> snapin, ref: src/discof/
restore/fd_snapct_tile.c, fd_snapin_tile.c:14-17), the account stream
riding frag links. Here:

  snapld  reads a snapshot file and publishes it as a MULTI-FRAG
          message: SOM on the first frag, EOM on the last (the tango
          ctl bits, ref: src/tango/fd_tango_base.h ctl SOM/EOM).
  snapdc  inflates a zstd stream between two links (the real archive
          format, flamenco/snapshot.py).
  snapin  reassembles the stream (SOM/EOM validated), then restores
          either the port's checkpoint frames (utils/checkpt.py: zlib
          frames + sha256 integrity trailer) into a private funk or
          into the topology's shm store, or (ArchiveInserter) the tar +
          AppendVec archive, whose lattice checksum is verified on
          `device` before anything installs.

Decompression and integrity checks happen INSIDE the readers, so a
corrupt stream fails loudly (tile FAIL) rather than installing bad
state. A shared-store restore is install-after-verify
(utils/checkpt.snapshot_restore_into): the whole stream drains and
validates (integrity trailer, row framing, record count, min_slot
staleness gate) BEFORE the first record installs, and only then does
snapin write the restore marker the replay tile's cold-start gate
polls. The loader carries the chaos seams of the snapshot drills
(corrupt_checkpt_frame, stale_snapshot_offer, crash_mid_snapshot).

Where the copy differs from the reference: the did-you-mean of
normalize_snapshot is difflib's (the reference's lint registry is not
ported); ArchiveInserter takes a `device` (default "cuda") for the
lattice check; SnapDecompress and ArchiveInserter raise at construction
when the `zstandard` package is missing, naming it (flamenco/snapshot.
zstandard_module), where the reference fails at the import.
"""
from __future__ import annotations

import hashlib
import io

CTL_SOM = 1
CTL_EOM = 2

# [snapshot] config section: its keys and defaults, as the reference's
SNAPSHOT_DEFAULTS = {
    "path": "",          # snapshot file (loader source / writer target)
    "every_slots": 0,    # replay tile writes a snapshot every N slots
    "min_slot": 0,       # snapin refuses snapshots older than this
    "compress": True,    # zlib-compress writer frames
    "chunk": 1024,       # snapld frag chunk bytes
}


def _suggest(key, candidates) -> str:
    """did-you-mean suffix for an unknown key ('' if none)."""
    import difflib
    close = difflib.get_close_matches(str(key), sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_snapshot(spec) -> dict:
    """Validate + default-fill a [snapshot] table. Same
    fail-before-launch stance as [funk]: raises ValueError with a
    did-you-mean."""
    out = dict(SNAPSHOT_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"snapshot spec must be a table, got {spec!r}")
    unknown = set(spec) - set(SNAPSHOT_DEFAULTS)
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown snapshot key(s) {sorted(unknown)}"
                         + _suggest(key, SNAPSHOT_DEFAULTS))
    out.update(spec)
    if not isinstance(out["path"], str):
        raise ValueError(
            f"snapshot.path must be a string, got {out['path']!r}")
    for key in ("every_slots", "min_slot"):
        out[key] = int(out[key])
        if out[key] < 0:
            raise ValueError(
                f"snapshot.{key} must be >= 0, got {out[key]}")
    out["compress"] = bool(out["compress"])
    out["chunk"] = int(out["chunk"])
    if out["chunk"] < 64:
        raise ValueError(
            f"snapshot.chunk must be >= 64, got {out['chunk']}")
    return out


def state_fingerprint(funk) -> int:
    """u64 fingerprint of the published root: sha256 over the
    DETERMINISTIC uncompressed checkpoint serialization. The restore
    marker (local runtime state, utils/checkpt.RESTORE_MARKER_KEY) is
    excluded so a restored store fingerprints identically to its
    source."""
    from ..utils.checkpt import RESTORE_MARKER_KEY, funk_checkpt
    items = {k: v for k, v in funk.root_items().items()
             if k != RESTORE_MARKER_KEY}
    shim = type("_Root", (), {"root_items": lambda self: items})()
    buf = io.BytesIO()
    funk_checkpt(shim, buf, compress=False)
    return int.from_bytes(
        hashlib.sha256(buf.getvalue()).digest()[:8], "little")




def _read_frag(ring, seq):
    """Shared speculative lock-free read: -> (rc, ctl, payload).
    rc 1 = nothing new, rc -1 = overrun at seq, rc 0 = validated copy
    (payload re-checked against the slot's seq after copying)."""
    rc, frag = ring.consume(seq)
    if rc != 0:
        return rc, 0, b""
    payload = bytes(ring.payload(frag))
    rc2, check = ring.consume(seq)
    if rc2 != 0 or check.seq != frag.seq:
        return -1, 0, b""
    return 0, frag.ctl, payload


class SnapLoader:
    """snapld core: stream one file as a multi-frag message.

    Streaming read (never slurps — snapshots are multi-GB in
    production), and backpressure RETURNS to the stem instead of
    spinning so the tile keeps heartbeating and remains haltable."""

    def __init__(self, path: str, out_ring, out_fseqs, chunk: int = 1024):
        self.fp = open(path, "rb")
        self.size = __import__("os").fstat(self.fp.fileno()).st_size
        self.out = out_ring
        self.fseqs = out_fseqs or []
        self.chunk = min(chunk, out_ring.mtu)
        self.off = 0
        self._pending: bytes | None = None
        # chaos seams (armed by the adapter's on_chaos):
        self._corrupt_seed: int | None = None   # flip a byte in the
        self._crash_at: int | None = None       # next chunk / exit at off
        self.metrics = {"bytes": 0, "frags": 0, "done": 0,
                        "backpressure": 0, "total_bytes": self.size,
                        "corrupted": 0, "offers": 1}

    def offer(self, path: str):
        """Re-stream another snapshot file as a fresh SOM..EOM message
        (a second offer on the same link — the stale_snapshot_offer
        drill uses this to re-serve an old file; snapin's min_slot gate
        must refuse it loudly)."""
        if not self.fp.closed:
            self.fp.close()
        self.fp = open(path, "rb")
        self.size = __import__("os").fstat(self.fp.fileno()).st_size
        self.off = 0
        self._pending = None
        self.metrics["done"] = 0
        self.metrics["total_bytes"] = self.size
        self.metrics["offers"] += 1

    def poll_once(self) -> int:
        if self.size == 0:
            # empty file: still a complete (SOM|EOM) message — snapin's
            # frame reader then fails LOUDLY on the missing magic
            # rather than both tiles hanging silently
            if not self.metrics["done"]:
                self.out.publish(b"", sig=0, ctl=CTL_SOM | CTL_EOM)
                self.metrics["frags"] += 1
                self.metrics["done"] = 1
                return 1
            return 0
        if self.off >= self.size and self._pending is None:
            return 0
        n = 0
        while n < 16:
            if self._pending is None:
                # never read past the size captured at open: a file
                # that GREW since then must not push EOM off the end
                # (appended bytes are a new snapshot, not this stream)
                want = min(self.chunk, self.size - self.off)
                data = self.fp.read(want)
                if not data:
                    if self.off < self.size:
                        # file shrank after open: fail the tile loudly
                        # (stem flips cnc to FAIL) instead of leaving
                        # snapin waiting on an EOM that never comes
                        raise RuntimeError(
                            f"snapshot truncated: read {self.off} of "
                            f"{self.size} bytes")
                    break
                self._pending = data
            if self._crash_at is not None and self.off >= self._crash_at:
                # crash_mid_snapshot: die with the stream half-sent —
                # snapin must never install the partial message, and
                # the supervisor sees an abnormal death (EV_CHAOS was
                # already recorded, so the black box names the drill)
                __import__("os")._exit(71)
            if self._corrupt_seed is not None:
                # corrupt_checkpt_frame: flip ONE seeded byte in the
                # next chunk — the checkpt reader's integrity trailer
                # (or frame framing) must refuse the whole stream
                data = bytearray(self._pending)
                if data:
                    data[self._corrupt_seed % len(data)] ^= 0x40
                    self._pending = bytes(data)
                    self.metrics["corrupted"] += 1
                self._corrupt_seed = None
            if self.fseqs and self.out.credits(self.fseqs) <= 0:
                # yield to the stem: heartbeat/halt stay responsive
                self.metrics["backpressure"] += 1
                return n
            data = self._pending
            end = self.off + len(data)
            ctl = (CTL_SOM if self.off == 0 else 0) | \
                  (CTL_EOM if end == self.size else 0)
            self.out.publish(data, sig=self.metrics["frags"], ctl=ctl)
            self._pending = None
            self.metrics["frags"] += 1
            self.metrics["bytes"] += len(data)
            self.off = end
            n += 1
        if self.off >= self.size:
            self.metrics["done"] = 1
            self.fp.close()
        return n


class SnapInserter:
    """snapin core: multi-frag reassembly -> funk restore.

    `funk`: a pre-joined funk to restore INTO (the topology's
    shm store facade) so the exec/replay family sees the cold-start
    state; without it each message restores into a fresh private
    `funk_cls()`. Either way the restore is install-after-verify
    (utils/checkpt.snapshot_restore_into) and a snapshot older than
    `min_slot` is REFUSED loudly (stale_snapshot_offer drill)."""

    def __init__(self, in_ring, funk_cls=None, funk=None, min_slot=0):
        from ..funk.funk import Funk
        self.ring = in_ring
        self.funk_cls = funk_cls or Funk
        self.funk = funk
        self._target = funk
        self.min_slot = int(min_slot)
        self.seq = 0
        self._buf = bytearray()
        self._in_msg = False
        self.metrics = {"frags": 0, "bytes": 0, "accounts": 0,
                        "restored": 0, "fingerprint": 0,
                        "stream_err": 0, "slot": 0}

    def poll_once(self) -> int:
        got = 0
        while True:
            rc, ctl, payload = _read_frag(self.ring, self.seq)
            if rc == 1:
                return got
            if rc == -1:
                # overrun mid-snapshot is fatal for the stream: restart
                self._buf.clear()
                self._in_msg = False
                self.metrics["stream_err"] += 1
                self.seq += 1
                got += 1
                continue
            self.seq += 1
            got += 1
            self.metrics["frags"] += 1
            self.metrics["bytes"] += len(payload)
            if ctl & CTL_SOM:
                self._buf.clear()
                self._in_msg = True
            if not self._in_msg:
                self.metrics["stream_err"] += 1
                continue
            self._buf += payload
            if ctl & CTL_EOM:
                self._restore()
                self._in_msg = False

    def _restore(self):
        from ..utils.checkpt import snapshot_restore_into
        target = self._target if self._target is not None \
            else self.funk_cls()
        min_slot = self.min_slot or None
        slot, _bank_hash, _cnt = snapshot_restore_into(
            target, io.BytesIO(bytes(self._buf)), min_slot=min_slot)
        # install succeeded: only now does the restored funk become
        # visible (a raise above leaves self.funk and the store as
        # they were — no partial state, the install-after-verify
        # contract)
        self.funk = target
        self._buf.clear()
        self.metrics["accounts"] = _cnt
        self.metrics["fingerprint"] = state_fingerprint(self.funk)
        self.metrics["slot"] = slot
        self.metrics["restored"] += 1
        if self._target is not None:
            # shared-store restore: install the marker the replay
            # tile's cold-start gate polls for (AFTER the fingerprint,
            # so the fingerprint metric reflects the snapshot alone)
            from ..utils.checkpt import RESTORE_MARKER_KEY
            self.funk.rec_write(None, RESTORE_MARKER_KEY,
                                (slot, _bank_hash))


class SnapDecompress:
    """snapdc core (ref: src/discof/restore/ snapdc stage): streaming
    zstd decompress between two frag links. SOM/EOM bracket the
    message on both sides; decompressed output re-chunks to the out
    ring's mtu."""

    def __init__(self, in_ring, out_ring, out_fseqs):
        from ..flamenco.snapshot import zstandard_module
        zstandard = zstandard_module()
        self.ring = in_ring
        self.out = out_ring
        self.fseqs = out_fseqs or []
        self.seq = 0
        self._d = zstandard.ZstdDecompressor().decompressobj()
        self._started = False
        self._out_seq = 0
        self._pending: list[tuple[bytes, int]] = []
        self.metrics = {"in_bytes": 0, "out_bytes": 0, "frags": 0,
                        "done": 0, "stream_err": 0, "backpressure": 0}

    def _drain(self) -> bool:
        """Publish pending chunks; False on backpressure (return to
        the stem — the tile must keep heartbeating, SnapLoader's
        discipline)."""
        while self._pending:
            if self.fseqs and self.out.credits(self.fseqs) <= 0:
                self.metrics["backpressure"] += 1
                return False
            data, ctl = self._pending.pop(0)
            self.out.publish(data, sig=self._out_seq, ctl=ctl)
            self._out_seq += 1
            self.metrics["out_bytes"] += len(data)
        return True

    def poll_once(self) -> int:
        got = 0
        while True:
            if not self._drain():
                return got
            rc, ctl_in, payload = _read_frag(self.ring, self.seq)
            if rc == 1:
                return got
            if rc == -1:
                # an overrun or corrupt stream desyncs zstd for good:
                # fail LOUDLY (stem flips cnc FAIL) instead of hanging
                # the pipeline with no EOM
                raise RuntimeError("snapdc: input stream overrun")
            self.seq += 1
            got += 1
            self.metrics["frags"] += 1
            self.metrics["in_bytes"] += len(payload)
            try:
                raw = self._d.decompress(payload)
            except Exception as e:
                raise RuntimeError(f"snapdc: corrupt zstd stream: {e}")
            last_in = bool(ctl_in & CTL_EOM)
            mtu = self.out.mtu
            chunks = [raw[i:i + mtu] for i in range(0, len(raw), mtu)] \
                or ([b""] if last_in or not self._started else [])
            for i, c in enumerate(chunks):
                ctl = 0
                if not self._started:
                    ctl |= CTL_SOM
                    self._started = True
                if last_in and i == len(chunks) - 1:
                    ctl |= CTL_EOM
                self._pending.append((c, ctl))
            if last_in:
                self.metrics["done"] = 1


class ArchiveInserter:
    """Real-format snapin: decompressed tar stream -> AppendVec parse
    -> funk root, lattice checksum verified at EOM (ref:
    fd_snapin_tile.c:14-17 + the snapla/snapls verify fan-in)."""

    def __init__(self, in_ring, funk_cls=None, device="cuda"):
        from ..flamenco.snapshot import SnapshotRestorer, zstandard_module
        from ..funk.funk import Funk
        # the archive format's pipeline needs snapdc upstream: refuse
        # to boot without its package rather than wait on a stream
        # that cannot come
        zstandard_module()
        self.ring = in_ring
        self.funk = (funk_cls or Funk)()
        # stream is ALREADY decompressed (snapdc upstream)
        self._restorer = SnapshotRestorer(self.funk, compressed=False,
                                          device=device)
        self.seq = 0
        self.metrics = {"frags": 0, "bytes": 0, "accounts": 0,
                        "slot": 0, "lattice_ok": 0, "restored": 0,
                        "stream_err": 0}

    def poll_once(self) -> int:
        got = 0
        while True:
            rc, ctl, payload = _read_frag(self.ring, self.seq)
            if rc == 1:
                return got
            if rc == -1:
                raise RuntimeError("snapin: input stream overrun")
            self.seq += 1
            got += 1
            self.metrics["frags"] += 1
            self.metrics["bytes"] += len(payload)
            try:
                self._restorer.feed(payload)
            except Exception as e:
                # corrupt stream: fail the TILE (loud) — never leave
                # the pipeline waiting on an EOM that cannot land
                raise RuntimeError(f"snapin: corrupt snapshot: {e}")
            if ctl & CTL_EOM:
                ok = self._restorer.finish()
                self.metrics["accounts"] = self._restorer.accounts
                self.metrics["slot"] = self._restorer.slot or 0
                self.metrics["lattice_ok"] = 1 if ok else 0
                self.metrics["restored"] += 1
                if not ok:
                    raise RuntimeError(
                        "snapin: snapshot failed lattice verification")
