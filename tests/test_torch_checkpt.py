"""The port's checkpoint frames and v2 snapshots (firedancer_tpu_torch/
utils/checkpt.py) and its backtest ledger (app/backtest.py) against the
JAX package's: the same records from a numpy seed give byte-equal
streams, each package restores the other's into its Funk and its ShmFunk,
truncated, corrupt and stale streams are refused by the same exception
class with the target untouched, and a ledger either package records
replays through the other's, its divergence caught alike.

The reference's modules load its native library when imported, so they
are imported inside the `ref` fixture, not at collection."""
import io
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu_torch.funk.funk import Funk
from firedancer_tpu_torch.funk.shmfunk import ShmFunk
from firedancer_tpu_torch.svm.accdb import Account
from firedancer_tpu_torch.utils import checkpt as tck

BACKENDS = ["process", "shm"]


@pytest.fixture(scope="module")
def ref():
    from firedancer_tpu.funk import funk as jfunk
    from firedancer_tpu.funk import shmfunk as jshm
    from firedancer_tpu.svm import accdb as jaccdb
    from firedancer_tpu.tiles import snapshot as jsnap
    from firedancer_tpu.utils import checkpt as jck
    return SimpleNamespace(ck=jck, Funk=jfunk.Funk, ShmFunk=jshm.ShmFunk,
                           Account=jaccdb.Account, snap=jsnap)


def _mk(pkg, backend):
    """A funk of `pkg` ("port" or the ref namespace) and backend."""
    port = pkg == "port"
    if backend == "process":
        return Funk() if port else pkg.Funk()
    cls = ShmFunk if port else pkg.ShmFunk
    return cls(rec_max=1024, txn_max=16, heap_sz=1 << 20)


def _fini(funk):
    close = getattr(funk, "close", None)
    if close is not None:
        close(unlink=True)


def _records(n=20, seed=11):
    """[(key, value)] from `seed`: bare u64 ints and Accounts as plain
    tuples, built into either package's types by _populate."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = rng.bytes(32)
        if i % 2:
            out.append((k, int(rng.integers(0, 1 << 60))))
        else:
            out.append((k, (int(rng.integers(1, 1 << 50)),
                            rng.bytes(int(rng.integers(0, 64))),
                            rng.bytes(32), bool(i % 4 == 0), i)))
    return out


def _populate(funk, acct_cls, recs):
    for k, v in recs:
        funk.rec_write(None, k, acct_cls(*v) if isinstance(v, tuple) else v)


def _norm(items: dict) -> dict:
    """Root items as plain data, comparable across the packages."""
    return {k: ((v.lamports, bytes(v.data), bytes(v.owner), v.executable,
                 v.rent_epoch) if hasattr(v, "lamports") else v)
            for k, v in items.items()}


def _pair(ref, backend, recs):
    pf, jf = _mk("port", backend), _mk(ref, backend)
    _populate(pf, Account, recs)
    _populate(jf, ref.Account, recs)
    return pf, jf


# -- frames -----------------------------------------------------------------

@pytest.mark.parametrize("compress", [True, False])
def test_frames_are_byte_equal_and_cross_read(ref, compress):
    rng = np.random.default_rng(3)
    frames = [rng.bytes(int(rng.integers(0, 5000))) for _ in range(20)]
    frames.append(b"\x00" * 100_000)          # compressible
    out = []
    for mod in (tck, ref.ck):
        buf = io.BytesIO()
        w = mod.CheckptWriter(buf, compress=compress)
        for f in frames:
            w.frame(f)
        w.fini()
        out.append(buf.getvalue())
    assert out[0] == out[1]
    for mod in (tck, ref.ck):
        assert list(mod.CheckptReader(io.BytesIO(out[0])).frames()) == frames
    bad = bytearray(out[0])
    bad[len(bad) // 2] ^= 1
    for mod in (tck, ref.ck):
        with pytest.raises(mod.CheckptError):
            list(mod.CheckptReader(io.BytesIO(bytes(bad))).frames())


def test_bounded_inflate_and_trailing_garbage_refused_alike(ref):
    bomb = zlib.compress(b"\x00" * (1 << 20))
    junk = zlib.compress(b"hello") + b"JUNK"
    for body, raw_sz in ((bomb, 16), (junk, 5)):
        frame = struct.pack("<BQQ", tck.STYLE_ZLIB, raw_sz, len(body)) + body
        for mod in (tck, ref.ck):
            with pytest.raises(mod.CheckptError):
                list(mod.CheckptReader(io.BytesIO(mod.MAGIC + frame)).frames())
    assert (tck.MAGIC, tck.SNAP_META, tck.FRAME_MAX, tck.RESTORE_MARKER_KEY) \
        == (ref.ck.MAGIC, ref.ck.SNAP_META, ref.ck.FRAME_MAX,
            ref.ck.RESTORE_MARKER_KEY)


# -- funk checkpoints -------------------------------------------------------

def test_funk_checkpt_is_byte_equal_and_restores_in_the_other(ref):
    recs = _records(50, seed=5)
    pf, jf = _pair(ref, "process", recs)
    bufs = []
    for mod, funk in ((tck, pf), (ref.ck, jf)):
        buf = io.BytesIO()
        mod.funk_checkpt(funk, buf)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    got = tck.funk_restore(Funk, io.BytesIO(bufs[1]))
    want = ref.ck.funk_restore(ref.Funk, io.BytesIO(bufs[0]))
    assert _norm(got.root_items()) == _norm(want.root_items()) \
        == _norm(pf.root_items())


def test_funk_restore_refuses_short_record_keys_alike(ref):
    buf = io.BytesIO()
    w = tck.CheckptWriter(buf, compress=False)
    w.frame(struct.pack("<Q", 1))
    k, ev = b"root8byt", tck._enc_val(7)
    w.frame(struct.pack("<II", len(k), len(ev)) + k + ev)
    w.fini()
    for mod, cls in ((tck, Funk), (ref.ck, ref.Funk)):
        with pytest.raises(mod.CheckptError, match="8-byte record key"):
            mod.funk_restore(cls, io.BytesIO(buf.getvalue()))


# -- v2 snapshots -----------------------------------------------------------

def _snap(mod, funk, slot=7, compress=True):
    buf = io.BytesIO()
    mod.snapshot_checkpt(funk, buf, slot=slot, bank_hash=bytes(range(32)),
                         compress=compress)
    return buf.getvalue()


@pytest.mark.parametrize("src", BACKENDS)
def test_snapshot_stream_is_byte_equal(ref, src):
    """Both packages' snapshot of the same records, from either backend,
    is the same stream (an shm store serves its own value bytes)."""
    pf, jf = _pair(ref, src, _records())
    try:
        for compress in (True, False):
            assert _snap(tck, pf, compress=compress) \
                == _snap(ref.ck, jf, compress=compress)
        assert _snap(tck, pf) == _snap(tck, _rebuilt(pf))
    finally:
        _fini(pf)
        _fini(jf)


def _rebuilt(funk):
    f = Funk()
    for k, v in funk.root_items().items():
        f.rec_write(None, k, v)
    return f


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("dst", BACKENDS)
def test_snapshot_restores_in_either_package(ref, writer, dst):
    """A snapshot written by one package restores into the other's (and
    its own) Funk and ShmFunk with the same (slot, bank hash, count) and
    records."""
    recs = _records(30, seed=9)
    pf, jf = _pair(ref, "shm", recs)
    raw = _snap(tck, pf) if writer == "port" else _snap(ref.ck, jf)
    targets = [(tck, _mk("port", dst)), (ref.ck, _mk(ref, dst))]
    try:
        got = [mod.snapshot_restore_into(t, io.BytesIO(raw))
               for mod, t in targets]
        assert got[0] == got[1] == (7, bytes(range(32)), len(recs))
        assert _norm(targets[0][1].root_items()) \
            == _norm(targets[1][1].root_items()) == _norm(pf.root_items())
    finally:
        for f in (pf, jf) + tuple(t for _, t in targets):
            _fini(f)


def _damaged(raw: bytes) -> dict:
    return {"truncated": raw[:len(raw) // 2],
            "corrupt": raw[:len(raw) // 2] + bytes([raw[len(raw) // 2] ^ 0x40])
            + raw[len(raw) // 2 + 1:],
            "empty_stream": tck.MAGIC + struct.pack("<BQQ", 0xFF, 0, 0)
            + bytes(32)}


@pytest.mark.parametrize("dst", BACKENDS)
@pytest.mark.parametrize("fault", ["truncated", "corrupt", "empty_stream",
                                   "stale"])
def test_bad_streams_refused_alike_with_the_target_untouched(ref, dst,
                                                             fault):
    src = Funk()
    _populate(src, Account, _records(20, seed=4))
    raw = _snap(tck, src, compress=False)
    stream = raw if fault == "stale" else _damaged(raw)[fault]
    for mod, pkg in ((tck, "port"), (ref.ck, ref)):
        target = _mk(pkg, dst)
        try:
            target.rec_write(None, b"\x05" * 32, 55)
            before = target.root_items()
            with pytest.raises(mod.CheckptError) as ei:
                mod.snapshot_restore_into(target, io.BytesIO(stream),
                                          min_slot=8)
            assert target.root_items() == before
            if fault == "stale":
                assert "stale snapshot: slot 7 < required 8" in str(ei.value)
        finally:
            _fini(target)


@pytest.mark.parametrize("backend", BACKENDS)
def test_atomic_writer_crash_keeps_the_previous_file(ref, backend,
                                                     tmp_path):
    """A crash inside the writer (its _frame_hook seam) leaves the
    previous file as it was, restorable by both packages; the .tmp, if
    any, is refused."""
    funk = _mk("port", backend)
    path = str(tmp_path / "snap.ckpt")
    try:
        _populate(funk, Account, _records(4, seed=3))
        tck.snapshot_write_atomic(path, funk, slot=3,
                                  bank_hash=bytes(range(32)))
        before = open(path, "rb").read()
        funk.rec_write(None, b"\x07" * 32, 777)

        def boom(i):
            if i >= 2:
                raise RuntimeError("simulated crash mid-snapshot")
        with pytest.raises(RuntimeError):
            tck.snapshot_write_atomic(path, funk, slot=4,
                                      bank_hash=bytes(32), _frame_hook=boom)
        assert open(path, "rb").read() == before
        for mod, cls in ((tck, Funk), (ref.ck, ref.Funk)):
            assert mod.snapshot_restore_into(cls(), io.BytesIO(before))[0] \
                == 3
        if os.path.exists(path + ".tmp"):
            with pytest.raises(tck.CheckptError):
                tck.snapshot_restore_into(
                    Funk(), io.BytesIO(open(path + ".tmp", "rb").read()))
        # the same writes through the reference give the same file
        jf = ref.Funk()
        _populate(jf, ref.Account, _records(4, seed=3))
        ref.ck.snapshot_write_atomic(str(tmp_path / "j.ckpt"), jf, slot=3,
                                     bank_hash=bytes(range(32)))
        assert open(tmp_path / "j.ckpt", "rb").read() == before
    finally:
        _fini(funk)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_marker_is_excluded_and_fingerprints_match(ref, backend):
    pf, jf = _pair(ref, backend, _records(3, seed=9))
    try:
        for f in (pf, jf):
            f.rec_write(None, tck.RESTORE_MARKER_KEY, (3, bytes(32)))
        raw = _snap(tck, pf)
        assert raw == _snap(ref.ck, jf)
        fresh = Funk()
        assert tck.snapshot_restore_into(fresh, io.BytesIO(raw))[2] == 3
        assert tck.RESTORE_MARKER_KEY not in fresh.root_items()
        from firedancer_tpu_torch.tiles.snapshot import state_fingerprint
        assert state_fingerprint(pf) == ref.snap.state_fingerprint(jf) \
            == state_fingerprint(fresh)
    finally:
        _fini(pf)
        _fini(jf)


def test_legacy_checkpt_restores_as_slot_zero_alike(ref):
    recs = _records(5, seed=2)
    pf, jf = _pair(ref, "process", recs)
    buf = io.BytesIO()
    tck.funk_checkpt(pf, buf)
    for mod, pkg in ((tck, "port"), (ref.ck, ref)):
        cold = _mk(pkg, "shm")
        try:
            assert mod.snapshot_restore_into(
                cold, io.BytesIO(buf.getvalue())) == (0, bytes(32), 5)
            assert _norm(cold.root_items()) == _norm(pf.root_items())
        finally:
            _fini(cold)


# -- backtest ledgers -------------------------------------------------------

def _ledger_blocks(build_message, build_txn, rng):
    def k(n):
        return bytes([n]) * 32

    def transfer(src, dst, amount):
        data = struct.pack("<IQ", 2, amount)
        msg = build_message([k(src)], [k(dst), bytes(32)], b"\x55" * 32,
                            [(2, bytes([0, 1]), data)])
        return build_txn([bytes(64)], msg)
    blocks = []
    for slot in range(1, 6):
        blocks.append((slot, [
            transfer(int(rng.integers(1, 6)), int(rng.integers(1, 9)),
                     int(rng.integers(1, 5000)))
            for _ in range(int(rng.integers(1, 5)))]))
    return blocks


@pytest.fixture(scope="module")
def ledgers(ref):
    """One ledger recorded by each package from the same genesis and
    blocks (the port's bank hashes on the CPU)."""
    from firedancer_tpu.app import backtest as jbt
    from firedancer_tpu_torch.app import backtest as tbt
    from firedancer_tpu_torch.protocol.txn import build_message, build_txn
    blocks = _ledger_blocks(build_message, build_txn,
                            np.random.default_rng(3))
    out = {}
    for name, bt, fcls, acls, kw in (
            ("port", tbt, Funk, Account, {"device": "cpu"}),
            ("ref", jbt, ref.Funk, ref.Account, {})):
        g = fcls()
        for i in range(1, 6):
            g.rec_write(None, bytes([i]) * 32, acls(lamports=10_000_000))
        buf = io.BytesIO()
        fp = bt.record(g, blocks, buf, **kw)
        out[name] = (buf.getvalue(), fp)
    return SimpleNamespace(blocks=blocks, bt=(tbt, jbt), **out)


def test_backtest_ledgers_are_byte_equal_and_cross_replay(ledgers):
    tbt, jbt = ledgers.bt
    assert ledgers.port == ledgers.ref
    raw, fp = ledgers.port
    got = tbt.replay(io.BytesIO(raw), device="cpu")
    want = jbt.replay(io.BytesIO(raw))
    for key in ("blocks", "txns", "executed_ok", "fingerprint"):
        assert got[key] == want[key]
    assert got["fingerprint"] == fp and got["blocks"] == 5


def _rewritten(raw: bytes, edit) -> bytes:
    """The ledger with `edit(frames)` applied, re-framed."""
    frames = list(tck.CheckptReader(io.BytesIO(raw)).frames())
    edit(frames)
    buf = io.BytesIO()
    w = tck.CheckptWriter(buf)
    for f in frames:
        w.frame(f)
    w.fini()
    return buf.getvalue()


def _flip_block_hash(frames):
    """The second block's recorded bank hash, one bit off."""
    frames[2] = frames[2][:-1] + bytes([frames[2][-1] ^ 1])


def _flip_fingerprint(frames):
    frames[-1] = (int.from_bytes(frames[-1], "little") ^ 1).to_bytes(
        8, "little")


@pytest.mark.parametrize("fault", ["bank_hash", "fingerprint"])
def test_backtest_divergence_is_caught_alike(ledgers, fault):
    tbt, jbt = ledgers.bt
    edit, match = ((_flip_block_hash, "bank hash diverged at slot 2")
                   if fault == "bank_hash"
                   else (_flip_fingerprint, "state diverged"))
    bad = _rewritten(ledgers.port[0], edit)
    with pytest.raises(AssertionError, match=match):
        tbt.replay(io.BytesIO(bad), device="cpu")
    with pytest.raises(AssertionError, match=match):
        jbt.replay(io.BytesIO(bad))


def test_backtest_cli_replays_on_the_cpu(ledgers, tmp_path, capsys):
    tbt, _ = ledgers.bt
    path = tmp_path / "ledger.bin"
    path.write_bytes(ledgers.port[0])
    assert tbt.main(["replay", str(path), "--device", "cpu"]) == 0
    assert "'fingerprint'" in capsys.readouterr().out
    assert tbt.main(["bogus"]) == 1
