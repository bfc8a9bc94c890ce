"""The port's snapshot archive format (firedancer_tpu_torch/flamenco/
snapshot.py) against the JAX package's: AppendVec bytes, the streaming
tar reader, the archive (its manifest's lattice checksum from the
reference's lthash on the CPU backend), each package restoring the
other's archive with the lattice checked, tampered and incomplete
archives refused alike, and the bank hash's chunked lthash fold equal to
one launch. Accounts come from a numpy seed; every comparison is exact.

The reference's modules load its native library when imported, so they
are imported inside the `ref` fixture, not at collection."""
import io
import struct
import sys
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu_torch.flamenco import bank_hash as tbh
from firedancer_tpu_torch.flamenco import snapshot as tsnap
from firedancer_tpu_torch.funk.funk import Funk
from firedancer_tpu_torch.svm.accdb import Account

zstandard = pytest.importorskip("zstandard")


@pytest.fixture(scope="module")
def ref():
    from firedancer_tpu.flamenco import bank_hash as jbh
    from firedancer_tpu.flamenco import snapshot as jsnap
    from firedancer_tpu.funk.funk import Funk as JFunk
    from firedancer_tpu.svm.accdb import Account as JAccount
    return SimpleNamespace(snap=jsnap, bh=jbh, Funk=JFunk, Account=JAccount)


def _accounts(n=300, seed=0):
    """[(pubkey, (lamports, data, owner, executable, rent_epoch))]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append((rng.bytes(32), (
            int(rng.integers(1, 1 << 50)), rng.bytes(int(rng.integers(0, 200))),
            rng.bytes(32), bool(i % 7 == 0), int(rng.integers(0, 9)))))
    return out


def _funk(fcls, acls, accts):
    funk = fcls()
    for k, v in accts:
        funk.rec_write(None, k, acls(*v))
    return funk


def _norm(items: dict) -> dict:
    return {k: (v.lamports, bytes(v.data), bytes(v.owner), v.executable,
                v.rent_epoch) for k, v in items.items()}


def test_append_vec_bytes_equal_and_parse_alike(ref):
    accts = _accounts(40, seed=1)
    got = tsnap.write_append_vec([(k, Account(*v)) for k, v in accts])
    want = ref.snap.write_append_vec([(k, ref.Account(*v))
                                      for k, v in accts])
    assert got == want
    assert [(k, (a.lamports, a.data, a.owner, a.executable, a.rent_epoch))
            for k, a in tsnap.parse_append_vec(want)] == accts
    a = Account(lamports=7, data=b"hello", owner=bytes([9]) * 32,
                executable=True, rent_epoch=3)
    b = tsnap.write_append_vec([(bytes([1]) * 32, a)])
    assert len(b) == 136 + 5 + 3 and b[104:136] == bytes(32)
    bad = bytearray(b)
    struct.pack_into("<Q", bad, 8, 1 << 40)       # hostile data_len
    for mod in (tsnap, ref.snap):
        with pytest.raises(ValueError, match="out of bounds"):
            mod.parse_append_vec(bytes(bad))
    junk = b + b"\x01" * 8
    for mod in (tsnap, ref.snap):
        with pytest.raises(ValueError, match="trailing garbage"):
            mod.parse_append_vec(junk)


@pytest.mark.parametrize("step", [1, 97, 512, 4096])
def test_tar_stream_incremental_alike(ref, step):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w",
                      format=tarfile.USTAR_FORMAT) as tf:
        for name, data in (("a", b"A" * 700), ("dir/b", b"B" * 3),
                           ("empty", b"")):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    raw = buf.getvalue()
    got = []
    for ts in (tsnap.TarStream(), ref.snap.TarStream()):
        out = []
        for i in range(0, len(raw), step):
            out.extend(ts.feed(raw[i:i + step]))
        assert ts.done
        got.append(out)
    assert got[0] == got[1] == [("a", b"A" * 700), ("dir/b", b"B" * 3),
                                ("empty", b"")]


def _write_both(ref, tmp_path, accts, slot=42, per_vec=64):
    pp, jp = str(tmp_path / "port.tar.zst"), str(tmp_path / "ref.tar.zst")
    tsnap.write_snapshot_archive(pp, slot, _funk(Funk, Account, accts),
                                 accounts_per_vec=per_vec, device="cpu")
    ref.snap.write_snapshot_archive(jp, slot,
                                    _funk(ref.Funk, ref.Account, accts),
                                    accounts_per_vec=per_vec)
    return pp, jp


def _tar(path):
    with open(path, "rb") as f:
        return zstandard.ZstdDecompressor().decompressobj().decompress(
            f.read())


def test_archive_is_equal_and_manifest_checksum_is_the_references(
        ref, tmp_path):
    """The same accounts archive to the same tar (and zstd stream); the
    manifest's checksum is the reference's lattice over the CPU
    backend."""
    accts = _accounts(300, seed=2)
    pp, jp = _write_both(ref, tmp_path, accts)
    assert _tar(pp) == _tar(jp)
    assert open(pp, "rb").read() == open(jp, "rb").read()
    members = dict(tsnap.TarStream().feed(_tar(pp)))
    slot, checksum, names = tsnap._parse_manifest(members["snapshots/42/42"])
    want = ref.bh.BankHasher(ref.bh.lthash_of_root(
        _funk(ref.Funk, ref.Account, accts))).checksum()
    assert (slot, checksum) == (42, want)
    assert names == [f"accounts/42.{i}" for i in range(5)]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_restores_the_others_archive(ref, tmp_path, writer):
    accts = _accounts(200, seed=3)
    pp, jp = _write_both(ref, tmp_path, accts, slot=9, per_vec=32)
    path = pp if writer == "port" else jp
    tf, jf = Funk(), ref.Funk()
    assert tsnap.restore_snapshot(path, tf, device="cpu") == (9, True)
    assert ref.snap.restore_snapshot(path, jf) == (9, True)
    assert _norm(tf.root_items()) == _norm(jf.root_items()) \
        == {k: v for k, v in accts}


def _tampered(path, slot):
    raw = bytearray(_tar(path))
    name = f"accounts/{slot}.0\x00".encode()
    idx = next(off for off in range(0, len(raw), 512)
               if raw[off:off + len(name)] == name)
    raw[idx + 512 + 48] ^= 1                      # first lamports field
    with open(path, "wb") as f:
        f.write(zstandard.ZstdCompressor().compress(bytes(raw)))


def _drop_last_vec(path, slot):
    members = tsnap.TarStream().feed(_tar(path))
    keep = members[:-1]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w",
                      format=tarfile.USTAR_FORMAT) as tf:
        for name, data in keep:
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    with open(path, "wb") as f:
        f.write(zstandard.ZstdCompressor().compress(buf.getvalue()))


@pytest.mark.parametrize("fault", ["tampered", "missing_vec"])
def test_bad_archive_refused_alike_and_nothing_installed(ref, tmp_path,
                                                         fault):
    accts = _accounts(80, seed=4)
    pp, _ = _write_both(ref, tmp_path, accts, slot=7, per_vec=32)
    (_tampered if fault == "tampered" else _drop_last_vec)(pp, 7)
    tf, jf = Funk(), ref.Funk()
    assert tsnap.restore_snapshot(pp, tf, device="cpu") == (7, False)
    assert ref.snap.restore_snapshot(pp, jf) == (7, False)
    assert tf.root_items() == {} and jf.root_items() == {}


def test_streaming_restorer_in_odd_chunks_alike(ref, tmp_path):
    accts = _accounts(120, seed=5)
    accts[3] = (accts[3][0], (0,) + accts[3][1][1:])   # a zero-lamport one
    pp, _ = _write_both(ref, tmp_path, accts, slot=9, per_vec=32)
    blob = open(pp, "rb").read()
    got = []
    for r, funk in ((tsnap.SnapshotRestorer(Funk(), device="cpu"), None),
                    (ref.snap.SnapshotRestorer(ref.Funk()), None)):
        for i in range(0, len(blob), 333):
            r.feed(blob[i:i + 333])
        assert r.finish()
        got.append((r.accounts, r.slot, _norm(r.funk.root_items())))
    assert got[0] == got[1]
    assert got[0][0] == 120 and accts[3][0] not in got[0][2]


@pytest.mark.parametrize("chunk", [5, 16])
def test_chunked_lthash_fold_equals_one_launch(ref, chunk):
    """accounts_lthash in launches of `chunk` lanes, the partial sums
    added mod 2^16, equals the one-launch fold and the reference's."""
    accts = [(k, Account(*v)) for k, v in _accounts(40, seed=6)]
    one = tbh.accounts_lthash(accts, "cpu", chunk=len(accts))
    got = tbh.accounts_lthash(accts, "cpu", chunk=chunk)
    want = ref.bh.accounts_lthash([(k, ref.Account(*v)) for k, v in
                                   _accounts(40, seed=6)])
    assert got.dtype == one.dtype == np.uint16
    assert np.array_equal(got, one) and np.array_equal(got, want)


def test_lane_msgs_pads_each_row(ref):
    raws = [b"", b"a", b"hello world", bytes(range(200))]
    msgs, lens = tbh.lane_msgs(raws)
    assert msgs.shape == (4, 200) and list(lens) == [0, 1, 11, 200]
    for row, raw in zip(msgs, raws):
        assert row[:len(raw)].tobytes() == raw and not row[len(raw):].any()


def test_archive_format_without_zstandard_raises_naming_it(monkeypatch):
    """Where the package is missing, the archive format and the tiles
    that need it refuse at construction, naming it; the checkpoint
    format needs only zlib."""
    from firedancer_tpu_torch.runtime import Workspace
    from firedancer_tpu_torch.runtime import Ring
    from firedancer_tpu_torch.tiles.snapshot import (ArchiveInserter,
                                                      SnapDecompress)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    w = Workspace(f"/fdtt_nozstd_{id(monkeypatch):x}", 1 << 20)
    try:
        ring = Ring.create(w, depth=8, mtu=1024)
        for make in (lambda: tsnap.zstandard_module(),
                     lambda: tsnap.SnapshotRestorer(Funk(), device="cpu"),
                     lambda: SnapDecompress(ring, ring, []),
                     lambda: ArchiveInserter(ring, device="cpu")):
            with pytest.raises(ModuleNotFoundError, match="`zstandard`"):
                make()
        assert tsnap.SnapshotRestorer(Funk(), compressed=False,
                                      device="cpu").accounts == 0
    finally:
        w.close()
        w.unlink()
