"""Solana snapshot archive formats: zstd stream -> tar -> AppendVec (copy
of the JAX package's flamenco/snapshot.py: the AppendVec layout,
TarStream, the manifest, write_snapshot_archive, SnapshotRestorer and
restore_snapshot, byte-compatible with the reference's).

The reference's restore pipeline is a tile chain — snapct/snapld
(download/read), snapdc (zstd), snapin (tar + AppendVec parse into the
account DB) with a parallel lattice-hash verification fan-out
(ref: src/discof/restore/fd_snapin_tile.c:14-17, fd_snapct_tile.c,
snapla/snapls). This module provides the FORMAT layer those tiles
speak:

  * AppendVec: Agave's account-storage file layout, byte-compatible —
    per entry StoredMeta(write_version u64, data_len u64, pubkey 32) |
    AccountMeta(lamports u64, rent_epoch u64, owner 32, executable u8,
    7B pad) | stored hash 32 | data | pad to 8 (the 136-byte
    STORE_META_OVERHEAD; the hash field is vestigial in modern Agave
    and written as zeros, accepted as-is on read)
  * TarStream: incremental ustar parser (512-byte headers, NUL-name
    terminator) usable from a tile that receives the byte stream as
    ring frags
  * archive writer/reader: `<slot>/...` tar.zst with a version file, a
    minimal manifest (slot + accounts lattice checksum + appendvec
    list; the full Agave bank manifest is not reproduced, as in the
    reference), and one AppendVec per accounts file
  * restore verification: the restored accounts' lattice hash must
    match the manifest checksum (the snapla/snapls fan-in: every staged
    account a lane of the BLAKE3 kernel's `lthash` entry on `device`,
    flamenco/bank_hash.accounts_lthash)

Where the copy differs from the reference: write_snapshot_archive,
SnapshotRestorer and restore_snapshot take a `device` (default "cuda")
for their lthash work, and the `zstandard` package is imported through
`zstandard_module`, which raises naming it when it is missing.
"""
from __future__ import annotations

import io
import struct
import tarfile

from ..funk.funk import key32
from ..svm.accdb import Account

STORED_META = struct.Struct("<QQ32s")          # write_version, dlen, key
ACCOUNT_META = struct.Struct("<QQ32sB7x")      # lamports, rent, owner, exec
STORED_HASH_SZ = 32                            # vestigial, zeros


def zstandard_module():
    """The `zstandard` package (the archive format's compression), or a
    ModuleNotFoundError that names it: the checkpoint format
    (utils/checkpt.py) needs only zlib, the archive format this."""
    try:
        import zstandard
    except ImportError as e:
        raise ModuleNotFoundError(
            "the snapshot archive format (snapdc, snapin "
            "format=\"archive\") needs the `zstandard` package, which "
            "is not installed", name="zstandard") from e
    return zstandard


def _pad8(n: int) -> int:
    return (-n) % 8


def write_append_vec(items) -> bytes:
    """[(pubkey, Account)] -> AppendVec bytes (Agave account storage
    entry layout; write_version is a monotonic counter)."""
    out = bytearray()
    for wv, (pk, a) in enumerate(items):
        out += STORED_META.pack(wv, len(a.data), pk)
        out += ACCOUNT_META.pack(a.lamports, a.rent_epoch, a.owner,
                                 1 if a.executable else 0)
        out += bytes(STORED_HASH_SZ)
        out += a.data
        out += bytes(_pad8(len(a.data)))
    return bytes(out)


def parse_append_vec(data: bytes) -> list:
    """AppendVec bytes -> [(pubkey, Account)] with bounds checking
    (hostile snapshots must fail cleanly, fd_snapin's stance)."""
    out = []
    off = 0
    n = len(data)
    hdr = STORED_META.size + ACCOUNT_META.size + STORED_HASH_SZ
    while off + hdr <= n:
        wv, dlen, pk = STORED_META.unpack_from(data, off)
        lam, rent, owner, execu = ACCOUNT_META.unpack_from(
            data, off + STORED_META.size)
        off += hdr
        if dlen > n - off:
            raise ValueError("append-vec entry data out of bounds")
        acct_data = bytes(data[off:off + dlen])
        off += dlen + _pad8(dlen)
        out.append((bytes(pk), Account(lam, acct_data, bytes(owner),
                                       bool(execu), rent)))
    if off < n and any(data[off:]):
        raise ValueError("trailing garbage in append-vec")
    return out


# ---------------------------------------------------------------------------
# incremental tar (ustar) parsing — tile-friendly
# ---------------------------------------------------------------------------

class TarStream:
    """Feed raw tar bytes in arbitrary chunk sizes; yields complete
    (name, payload) members. Zero-block terminator ends the stream."""

    def __init__(self):
        self._buf = bytearray()
        self.done = False

    def feed(self, chunk: bytes) -> list:
        """-> complete (name, payload) members unlocked by this chunk."""
        self._buf += chunk
        out = []
        while not self.done:
            if len(self._buf) < 512:
                break
            hdr = bytes(self._buf[:512])
            if hdr == bytes(512):
                self.done = True
                break
            name = hdr[:100].split(b"\x00")[0].decode("utf-8")
            size_field = hdr[124:136].split(b"\x00")[0].strip()
            size = int(size_field or b"0", 8)
            total = 512 + size + _pad512(size)
            if len(self._buf) < total:
                break
            payload = bytes(self._buf[512:512 + size])
            del self._buf[:total]
            if hdr[156:157] in (b"0", b"\x00"):    # regular file only
                out.append((name, payload))
        return out


def _pad512(n: int) -> int:
    return (-n) % 512


# ---------------------------------------------------------------------------
# archive write / restore
# ---------------------------------------------------------------------------

MANIFEST_MAGIC = b"FDTPUSNAP1"


def _manifest_bytes(slot: int, lt_checksum: bytes,
                    vec_names: list[str]) -> bytes:
    out = bytearray(MANIFEST_MAGIC)
    out += struct.pack("<Q", slot)
    out += lt_checksum
    out += struct.pack("<H", len(vec_names))
    for nm in vec_names:
        b = nm.encode()
        out += struct.pack("<H", len(b)) + b
    return bytes(out)


def _parse_manifest(b: bytes):
    if b[:len(MANIFEST_MAGIC)] != MANIFEST_MAGIC:
        raise ValueError("bad manifest magic")
    off = len(MANIFEST_MAGIC)
    (slot,) = struct.unpack_from("<Q", b, off)
    off += 8
    checksum = bytes(b[off:off + 32])
    off += 32
    (n,) = struct.unpack_from("<H", b, off)
    off += 2
    names = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", b, off)
        off += 2
        names.append(b[off:off + ln].decode())
        off += ln
    return slot, checksum, names


def write_snapshot_archive(path: str, slot: int, funk,
                           accounts_per_vec: int = 1024, device="cuda"):
    """funk root -> <path> (tar.zst): version | snapshots/<slot>/<slot>
    manifest | accounts/<slot>.N AppendVecs. The manifest records the
    accounts lattice checksum the restorer must reproduce. The tar
    streams through the zstd compressor (snapshots are multi-GB in
    production; peak memory stays one AppendVec, not the archive). The
    checksum's lthash runs on `device`."""
    zstandard = zstandard_module()

    from .bank_hash import BankHasher, lthash_of_root
    items = sorted(
        ((k, v) for k, v in funk.root_items().items()
         if isinstance(v, Account)), key=lambda kv: kv[0])
    h = BankHasher(lthash_of_root(funk, device), device)
    vec_names = [f"accounts/{slot}.{i // accounts_per_vec}"
                 for i in range(0, max(len(items), 1),
                                accounts_per_vec)]
    manifest = _manifest_bytes(slot, h.checksum(), vec_names)
    with open(path, "wb") as f, \
            zstandard.ZstdCompressor(level=3).stream_writer(f) as zw, \
            tarfile.open(fileobj=zw, mode="w|",
                         format=tarfile.USTAR_FORMAT) as tf:
        def add(name, data):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
        add("version", b"1.2.0")
        add(f"snapshots/{slot}/{slot}", manifest)
        for vi, nm in enumerate(vec_names):
            i = vi * accounts_per_vec
            add(nm, write_append_vec(items[i:i + accounts_per_vec]))


class SnapshotRestorer:
    """Streaming restore: feed zstd-compressed chunks (the snapdc +
    snapin stages fused at the format level). Accounts accumulate in a
    STAGING area; `finish()` verifies the lattice checksum and only
    then installs them into the funk root — a tampered snapshot never
    leaves bad state behind (fd_snapin's stance)."""

    def __init__(self, funk, compressed: bool = True, device="cuda"):
        """compressed=False when a snapdc stage upstream already
        inflated the stream (the tile pipeline split); the lattice
        check runs on `device`."""
        self.funk = funk
        self.device = device
        self._dctx = None
        if compressed:
            zstandard = zstandard_module()
            self._dctx = zstandard.ZstdDecompressor().decompressobj()
        self._tar = TarStream()
        self.slot = None
        self._checksum = None
        self._expected_vecs: list[str] | None = None
        self._seen_vecs: set[str] = set()
        self._staging: dict[bytes, Account] = {}
        self.accounts = 0

    def feed(self, chunk: bytes):
        raw = self._dctx.decompress(chunk) if self._dctx else chunk
        if not raw:
            return
        for name, payload in self._tar.feed(raw):
            if name.startswith("snapshots/"):
                self.slot, self._checksum, self._expected_vecs = \
                    _parse_manifest(payload)
            elif name.startswith("accounts/"):
                self._seen_vecs.add(name)
                for pk, acct in parse_append_vec(payload):
                    self._staging[pk] = acct
                    self.accounts += 1

    def finish(self) -> bool:
        """True iff every manifest-listed vec arrived AND the staged
        accounts reproduce the manifest's lattice checksum — only a
        verified snapshot installs into the funk root."""
        from .bank_hash import BankHasher, accounts_lthash
        if self._expected_vecs is None:
            raise ValueError("no manifest in stream")
        if set(self._expected_vecs) - self._seen_vecs:
            return False
        got = BankHasher(accounts_lthash(
            self._staging.items(), self.device), self.device).checksum()
        if got != self._checksum:
            return False
        for pk, acct in self._staging.items():
            # zero-lamport entries are outside the lattice commitment:
            # installing them would let a tampered snapshot smuggle
            # unverified state past the checksum
            if acct.lamports == 0:
                continue
            self.funk.rec_write(None, key32(pk), acct)
        self._staging.clear()
        return True


def restore_snapshot(path: str, funk, device="cuda") -> tuple[int, bool]:
    """-> (slot, checksum_ok); the lattice check runs on `device`."""
    r = SnapshotRestorer(funk, device=device)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 16)
            if not chunk:
                break
            r.feed(chunk)
    return r.slot, r.finish()
