"""Streaming checkpoint frames + funk state snapshot/restore (copy of
the JAX package's utils/checkpt.py: CheckptWriter, CheckptReader, the
tagged value codec, funk_checkpt, funk_restore, the v2 snapshot rows
snapshot_checkpt and snapshot_restore_into, snapshot_write_atomic and
RESTORE_MARKER_KEY; every stream is byte-identical to the reference's).

The reference's fd_checkpt writes framed, optionally-compressed streams
that restore bit-identically (ref: src/util/checkpt/fd_checkpt.h:10-60 —
RAW and LZ4 frame styles, size limits, integrity discipline); funk is
persistent via the same machinery, and the snapshot pipeline rebuilds
an account DB from a serialized stream (ref: src/discof/restore/
fd_snapin_tile.c). This module re-expresses both seams:

  * CheckptWriter/CheckptReader: magic + version header, then frames
    [u8 style | u64 raw_sz | u64 enc_sz | bytes], style RAW or ZLIB
    (zlib stands in for LZ4; same contract), closed by a sha256 trailer
    over every raw byte, verified on restore.
  * funk_checkpt / funk_restore: the published root of a Funk instance
    (records sorted by key for determinism) -> frames -> an equal Funk.
  * snapshot_checkpt / snapshot_restore_into: the v2 snapshot layout —
    one meta row (slot, bank hash, record count) then record rows
    carrying the shm store's OWN tag-framed value bytes
    (funk/shmfunk.py encode_value), so a ShmFunk's record map + heap
    serialize directly and either backend restores from either stream.
    Restore is INSTALL-AFTER-VERIFY: every row is read, decoded, and
    the sha256 trailer checked before the first write lands in the
    target — a truncated, corrupt, or stale stream refuses loudly with
    the target untouched.
  * snapshot_write_atomic: tmp + fsync + os.replace, so a writer crash
    mid-checkpoint leaves the previous snapshot file intact and the
    half-written .tmp fails verification rather than restoring.

Account record values serialize tagged: ints (legacy lamports) and
accdb Accounts both round-trip exactly.
"""
from __future__ import annotations

import hashlib
import os
import struct
import zlib

from ..funk.funk import key32

MAGIC = b"FDTPUCK1"
# v2 snapshot meta-row prefix (first frame of a snapshot_checkpt
# stream; a legacy funk_checkpt stream's first frame is the bare u64
# record count, so the two formats are self-distinguishing)
SNAP_META = b"FDTPUSN2"
STYLE_RAW = 0
STYLE_ZLIB = 1
FRAME_MAX = 1 << 30
# root marker snapin installs AFTER a successful shared-store restore
# (value = (slot, bank_hash)); the replay tile's cold-start gate polls
# it to learn the snapshot boundary. NUL-prefixed so it can never
# collide with an account pubkey, and NUL-padded to exactly 32 bytes —
# the native store ABI reads fixed 32-byte keys, so a short key would
# hash trailing garbage that differs per process.
RESTORE_MARKER_KEY = b"\x00fdtpu/restored".ljust(32, b"\x00")


class CheckptError(ValueError):
    pass


class CheckptWriter:
    def __init__(self, fp, compress: bool = True, level: int = 3):
        self.fp = fp
        self.compress = compress
        self.level = level
        self._sha = hashlib.sha256()
        self.fp.write(MAGIC)

    def frame(self, data: bytes):
        if len(data) > FRAME_MAX:
            raise CheckptError("frame too large")
        self._sha.update(data)
        enc = zlib.compress(data, self.level) if self.compress else data
        style = STYLE_ZLIB if self.compress and len(enc) < len(data) \
            else STYLE_RAW
        if style == STYLE_RAW:
            enc = data
        self.fp.write(struct.pack("<BQQ", style, len(data), len(enc)))
        self.fp.write(enc)

    def fini(self):
        """Terminal frame + integrity trailer."""
        self.fp.write(struct.pack("<BQQ", 0xFF, 0, 0))
        self.fp.write(self._sha.digest())


class CheckptReader:
    def __init__(self, fp):
        self.fp = fp
        self._sha = hashlib.sha256()
        if fp.read(len(MAGIC)) != MAGIC:
            raise CheckptError("bad checkpoint magic")

    def frames(self):
        while True:
            hdr = self.fp.read(17)
            if len(hdr) != 17:
                raise CheckptError("truncated frame header")
            style, raw_sz, enc_sz = struct.unpack("<BQQ", hdr)
            if style == 0xFF:
                want = self.fp.read(32)
                if want != self._sha.digest():
                    raise CheckptError("checkpoint integrity mismatch")
                return
            # bound BEFORE reading/decompressing: a corrupt or hostile
            # header (snapshots arrive over the network in production)
            # must not drive a huge allocation or a zip bomb ahead of
            # the integrity trailer
            if style not in (STYLE_RAW, STYLE_ZLIB):
                raise CheckptError(f"unknown frame style {style}")
            if raw_sz > FRAME_MAX or enc_sz > FRAME_MAX:
                raise CheckptError("frame size exceeds FRAME_MAX")
            enc = self.fp.read(enc_sz)
            if len(enc) != enc_sz:
                raise CheckptError("truncated frame")
            if style == STYLE_ZLIB:
                # bounded inflate: cap output at raw_sz so a hostile
                # header can't drive a multi-GiB allocation before the
                # equality check (zlib.decompress alone is unbounded)
                d = zlib.decompressobj()
                try:
                    data = d.decompress(enc, raw_sz + 1)
                except zlib.error as e:
                    raise CheckptError(f"frame decompress failed: {e}")
                if d.unconsumed_tail or d.unused_data or not d.eof:
                    raise CheckptError("frame decompress overrun")
            else:
                data = enc
            if len(data) != raw_sz:
                raise CheckptError("frame size mismatch")
            self._sha.update(data)
            yield data


# ---------------------------------------------------------------------------
# value (de)serialization — tagged, deterministic
# ---------------------------------------------------------------------------

_TAG_INT = 0
_TAG_ACCOUNT = 1
_TAG_BYTES = 2


def _enc_val(v) -> bytes:
    from ..svm.accdb import Account
    if isinstance(v, int):
        # lamports are u64 (the legacy genesis path can hold any u64)
        if not 0 <= v < (1 << 64):
            raise CheckptError(f"int record out of u64 range: {v}")
        return bytes([_TAG_INT]) + struct.pack("<Q", v)
    if isinstance(v, Account):
        return (bytes([_TAG_ACCOUNT])
                + struct.pack("<QI", v.lamports, len(v.data)) + v.data
                + v.owner + bytes([1 if v.executable else 0])
                + struct.pack("<Q", v.rent_epoch))
    if isinstance(v, bytes):
        return bytes([_TAG_BYTES]) + v
    raise CheckptError(f"unsupported record value type {type(v)}")


def _dec_val(b: bytes):
    from ..svm.accdb import Account
    tag = b[0]
    if tag == _TAG_INT:
        return struct.unpack_from("<Q", b, 1)[0]
    if tag == _TAG_ACCOUNT:
        lamports, dlen = struct.unpack_from("<QI", b, 1)
        p = 13
        data = b[p:p + dlen]
        owner = b[p + dlen:p + dlen + 32]
        executable = bool(b[p + dlen + 32])
        rent_epoch = struct.unpack_from("<Q", b, p + dlen + 33)[0]
        return Account(lamports, bytes(data), bytes(owner), executable,
                       rent_epoch)
    if tag == _TAG_BYTES:
        return b[1:]
    raise CheckptError(f"unknown value tag {tag}")


def funk_checkpt(funk, fp, compress: bool = True):
    """Serialize the PUBLISHED root (in-preparation forks are transient
    by definition — the reference checkpoints published state the same
    way). Deterministic: records sorted by key."""
    w = CheckptWriter(fp, compress)
    items = sorted(funk.root_items().items())
    w.frame(struct.pack("<Q", len(items)))
    for k, v in items:
        ev = _enc_val(v)
        w.frame(struct.pack("<II", len(k), len(ev)) + k + ev)
    w.fini()


def funk_restore(funk_cls, fp):
    """-> a fresh Funk whose root equals the checkpointed one."""
    funk = funk_cls()
    r = CheckptReader(fp)
    it = r.frames()
    try:
        hdr = next(it)
    except StopIteration:
        raise CheckptError("empty checkpoint") from None
    (cnt,) = struct.unpack("<Q", hdr)
    got = 0
    for data in it:
        klen, vlen = struct.unpack_from("<II", data, 0)
        k = data[8:8 + klen]
        v = _dec_val(data[8 + klen:8 + klen + vlen])
        if klen != 32 or len(k) != klen:
            raise CheckptError(
                f"corrupt checkpoint: {klen}-byte record key (funk "
                f"keys are exactly 32) — refusing to install a key no "
                f"other process could derive")
        funk.rec_write(None, key32(bytes(k)), v)
        got += 1
    if got != cnt:
        raise CheckptError(f"record count mismatch: {got} != {cnt}")
    return funk


# ---------------------------------------------------------------------------
# v2 snapshot rows: meta + the shm store's own value framing
# ---------------------------------------------------------------------------

def _raw_root_items(funk) -> list[tuple[bytes, bytes]]:
    """Published-root records as (key, tag-framed value bytes), sorted
    by key for determinism. A shm-backed funk (has `.raw`) serves its
    record map + heap bytes DIRECTLY; a process funk encodes through
    the same tag framing (funk/shmfunk.py encode_value), so the wire
    form is backend-independent."""
    raw = getattr(funk, "raw", None)
    if raw is not None:
        items = [(bytes(k), bytes(v)) for k, v in raw.iter_layer(0)
                 if v is not None]
    else:
        from ..funk.shmfunk import encode_value
        items = [(bytes(k), encode_value(v))
                 for k, v in funk.root_items().items()]
    # the restore marker is LOCAL runtime state (snapin's handoff to
    # replay), never chain state: a snapshot carrying it would falsely
    # signal a restore boundary on whoever restores it
    items = [(k, v) for k, v in items if k != RESTORE_MARKER_KEY]
    items.sort()
    return items


def snapshot_checkpt(funk, fp, slot: int = 0,
                     bank_hash: bytes = bytes(32), compress: bool = True):
    """v2 snapshot stream: meta row (SNAP_META | u64 slot | u64 count |
    32B bank hash) then one record row per published-root record. The
    meta row is what lets a restorer refuse a STALE offer (slot gate)
    and verify the restored state's bank hash before joining."""
    if len(bank_hash) != 32:
        raise CheckptError("bank_hash must be 32 bytes")
    w = CheckptWriter(fp, compress)
    items = _raw_root_items(funk)
    w.frame(SNAP_META + struct.pack("<QQ", int(slot), len(items))
            + bytes(bank_hash))
    for k, ev in items:
        w.frame(struct.pack("<II", len(k), len(ev)) + k + ev)
    w.fini()


def snapshot_restore_into(funk, fp, min_slot: int | None = None):
    """Restore a snapshot stream INTO an existing funk's published
    root — install-after-verify: the WHOLE stream (every row decoded,
    sha256 trailer checked, record count matched, slot gate passed)
    verifies before the first write lands, so a truncated/corrupt/
    stale stream leaves the target untouched. Accepts both the v2
    snapshot layout and a legacy funk_checkpt stream (meta-less,
    slot 0). -> (slot, bank_hash, record count)."""
    from ..funk.shmfunk import decode_value
    r = CheckptReader(fp)
    it = r.frames()
    try:
        hdr = next(it)
    except StopIteration:
        raise CheckptError("empty checkpoint") from None
    if hdr.startswith(SNAP_META):
        if len(hdr) != len(SNAP_META) + 16 + 32:
            raise CheckptError("bad snapshot meta row")
        slot, cnt = struct.unpack_from("<QQ", hdr, len(SNAP_META))
        bank_hash = bytes(hdr[len(SNAP_META) + 16:])
        legacy = False
    elif len(hdr) == 8:
        (cnt,) = struct.unpack("<Q", hdr)
        slot, bank_hash, legacy = 0, bytes(32), True
    else:
        raise CheckptError("bad snapshot meta row")
    if min_slot is not None and slot < int(min_slot):
        raise CheckptError(
            f"stale snapshot: slot {slot} < required {int(min_slot)}")
    # stage 1: drain EVERY frame (the reader verifies the integrity
    # trailer at the terminal frame) and decode every row — any failure
    # here refuses the snapshot with zero writes issued
    rows: list[tuple[bytes, bytes | None, object]] = []
    for data in it:
        if len(data) < 8:
            raise CheckptError("snapshot row too short")
        klen, vlen = struct.unpack_from("<II", data, 0)
        if 8 + klen + vlen != len(data):
            raise CheckptError("snapshot row size mismatch")
        k = bytes(data[8:8 + klen])
        ev = bytes(data[8 + klen:8 + klen + vlen])
        try:
            v = _dec_val(ev) if legacy else decode_value(ev)
        except CheckptError:
            raise
        except Exception as e:
            raise CheckptError(f"corrupt snapshot row: {e!r}") from None
        rows.append((k, None if legacy else ev, v))
    if len(rows) != cnt:
        raise CheckptError(
            f"record count mismatch: {len(rows)} != {cnt}")
    # stage 2: install. A shm-backed target takes the verified raw
    # bytes heap-direct; a process funk takes the decoded values.
    raw = getattr(funk, "raw", None)
    for k, ev, v in rows:
        if len(k) != 32:
            raise CheckptError(
                f"corrupt snapshot: {len(k)}-byte record key (funk "
                f"keys are exactly 32)")
        if raw is not None and ev is not None:
            rc = raw.put(0, k, ev)
            if rc != 0:
                raise MemoryError(
                    f"shm funk store full (rc {rc}): raise "
                    f"[funk] rec_max/heap_mb")
        else:
            funk.rec_write(None, key32(k), v)
    return int(slot), bank_hash, int(cnt)


def snapshot_write_atomic(path: str, funk, slot: int = 0,
                          bank_hash: bytes = bytes(32),
                          compress: bool = True, _frame_hook=None):
    """Crash-safe snapshot writer: stream to `<path>.tmp`, fsync, then
    os.replace into place — a writer crash mid-checkpoint leaves the
    previous snapshot intact, and the half-written .tmp fails
    magic/trailer verification if anything ever offers it. _frame_hook
    (called with the row index before each record row) is the chaos
    seam: the crash_mid_snapshot drill exits the process from inside
    it."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        w = CheckptWriter(f, compress)
        items = _raw_root_items(funk)
        w.frame(SNAP_META + struct.pack("<QQ", int(slot), len(items))
                + bytes(bank_hash))
        for i, (k, ev) in enumerate(items):
            if _frame_hook is not None:
                _frame_hook(i)
            w.frame(struct.pack("<II", len(k), len(ev)) + k + ev)
        w.fini()
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
