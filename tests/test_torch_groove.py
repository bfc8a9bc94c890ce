"""The port's groove cold store (firedancer_tpu_torch/groove/) and accdb v2
over it (svm/accdb_cold.py) against the JAX package's, on the same
operations: the scenarios of tests/test_groove.py and
tests/test_accdb_cold.py and a seeded random mix of puts, overwrites,
deletes and reopens. Every get, delete, length and stat equal, the
volume files byte for byte equal, and a directory either package wrote
reads the same through the other (one on-disk format)."""
import hashlib
import os
import random
import struct

import pytest

from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu.groove import groove as jgroove
from firedancer_tpu.svm import accdb as jaccdb
from firedancer_tpu.svm import accdb_cold as jcold
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.groove import groove as tgroove
from firedancer_tpu_torch.svm import accdb as taccdb
from firedancer_tpu_torch.svm import accdb_cold as tcold

GROOVES = (jgroove, tgroove)


def K(n):
    return bytes([n]) * 32


def volumes(d):
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read())
            .hexdigest() for n in sorted(os.listdir(d))}


def both_dirs(tmp_path, fn):
    """fn(groove module, dir) -> observations, run for each package in
    its own directory; observations and the volume files must be
    equal. -> the port's observations."""
    got = []
    for i, mod in enumerate(GROOVES):
        d = str(tmp_path / f"g{i}")
        got.append((fn(mod, d), volumes(d)))
    assert got[1] == got[0]
    return got[1][0]


def _get(g, key):
    v = g.get(key)
    return None if v is None else bytes(v)


def test_constants_match_reference():
    for name in ("MAGIC", "ST_LIVE", "ST_DEAD", "MIN_CLASS", "MAX_CLASS",
                 "VOLUME_SZ", "_HDR", "_HDR_SZ", "_CRC_SZ"):
        assert getattr(tgroove, name) == getattr(jgroove, name), name
    for n in (0, 1, 100, 5000, 1 << 20):
        assert tgroove._class_for(n) == jgroove._class_for(n)
    for mod in GROOVES:
        with pytest.raises(mod.GrooveError):
            mod._class_for(1 << 25)


def _roundtrip(mod, d):
    g = mod.GrooveStore(d)
    g.put(K(1), b"hello cold world")
    g.put(K(2), b"x" * 5000)
    out = [_get(g, K(1)), _get(g, K(2)), _get(g, K(9)), g.delete(K(1)),
           g.delete(K(1)), _get(g, K(1)), len(g)]
    g.put(K(3), b"b" * 10)           # reuses K(1)'s class-7 slot
    g.put(K(2), b"v2-longer-payload")
    out += [_get(g, K(2)), len(g), dict(g.stats)]
    g.close()
    return out


def _reopen(mod, d):
    rng = random.Random(19)
    g = mod.GrooveStore(d)
    blobs = {K(i): bytes(rng.randrange(256) for _ in range(50 * i + 10))
             for i in range(1, 20)}
    for key, v in blobs.items():
        g.put(key, v)
    g.delete(K(3))
    g.put(K(1), b"overwritten")
    g.flush()
    g.close()
    g2 = mod.GrooveStore(d)
    out = [len(g2), _get(g2, K(3)), _get(g2, K(1))]
    out += [_get(g2, key) == v for key, v in blobs.items()]
    g2.put(K(99), b"c" * 40)
    out.append(dict(g2.stats))
    g2.close()
    return out


def _torn(mod, d):
    g = mod.GrooveStore(d)
    g.put(K(1), b"good record")
    g.put(K(2), b"will be torn")
    g.put(K(3), b"corrupt my header")
    vid, off = g.meta[K(2)]
    g.vols[vid].mm[off + mod._HDR_SZ] ^= 0xFF
    vid, off = g.meta[K(3)]
    struct.pack_into("<I", g.vols[vid].mm, off + 40, 0x7FFFFFFF)
    g.flush()
    g.close()
    g2 = mod.GrooveStore(d)
    out = [_get(g2, K(1)), _get(g2, K(2)), _get(g2, K(3)), dict(g2.stats)]
    g2.close()
    return out


def _crash_window(mod, d):
    g = mod.GrooveStore(d)
    g.put(K(1), b"v1-old")
    old = g.meta[K(1)]
    g.put(K(1), b"v2-new")
    vid, off = old
    g.vols[vid].mm[off + 4] = mod.ST_LIVE
    g.flush()
    g.close()
    g2 = mod.GrooveStore(d)
    out = [dict(g2.stats), _get(g2, K(1))]
    g2.delete(K(1))
    g2.flush()
    g2.close()
    g3 = mod.GrooveStore(d)
    out.append(_get(g3, K(1)))
    g3.close()
    return out


def _random_mix(mod, d, seed):
    rng = random.Random(seed)
    g = mod.GrooveStore(d)
    out = []
    for step in range(300):
        op, key = rng.randrange(10), K(rng.randrange(1, 40))
        if op < 5:
            g.put(key, bytes([step & 0xFF]) * rng.choice(
                (0, 1, 90, 200, 700, 3000)))
        elif op < 7:
            out.append(g.delete(key))
        elif op < 9:
            out.append(_get(g, key))
        else:
            g.flush()
            g.close()
            g = mod.GrooveStore(d)
            out.append((len(g), dict(g.stats)))
    out.append((len(g), dict(g.stats)))
    g.close()
    return out


SCENARIOS = {"roundtrip": _roundtrip, "reopen": _reopen, "torn": _torn,
             "crash_window": _crash_window}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_groove_matches_reference(tmp_path, name):
    both_dirs(tmp_path, SCENARIOS[name])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_groove_random_mix_matches_reference(tmp_path, seed):
    both_dirs(tmp_path, lambda mod, d: _random_mix(mod, d, seed))


def test_groove_directory_reads_through_the_other_package(tmp_path):
    for i, (w, r) in enumerate(((jgroove, tgroove), (tgroove, jgroove))):
        d = str(tmp_path / f"x{i}")
        g = w.GrooveStore(d)
        for n in range(1, 12):
            g.put(K(n), bytes([n]) * (n * 300))
        g.delete(K(4))
        g.flush()
        g.close()
        g2 = r.GrooveStore(d)
        assert len(g2) == 10 and _get(g2, K(4)) is None
        assert all(_get(g2, K(n)) == bytes([n]) * (n * 300)
                   for n in range(1, 12) if n != 4)
        g2.close()


# -- accdb v2 ---------------------------------------------------------------

COLD = ((jfunk, jaccdb, jcold), (tfunk, taccdb, tcold))


def test_account_codec_matches_reference():
    for data, exe in ((b"", False), (b"\x07" * 99, True)):
        bs = [c.account_to_bytes(ad.Account(12345, data, K(9), exe, 3))
              for _, ad, c in COLD]
        assert bs[1] == bs[0]
        a = tcold.account_from_bytes(bs[0])
        assert (a.lamports, bytes(a.data), a.owner, a.executable,
                a.rent_epoch) == (12345, data, K(9), exe, 3)


def _cold_flow(fk, ad, cold, d):
    funk = fk.Funk()
    db = cold.AccDbCold(funk, d)
    for i in range(1, 9):
        funk.rec_write(None, K(i), ad.Account(i * 1000, b"x" * (i * 40)))
    out = [db.evict_larger_than(150), dict(db.cold_stats)]
    db.evict(K(1))
    out.append(funk.rec_query(None, K(1)) is None)
    funk.txn_prepare(None, "blk")
    a = db.peek("blk", K(1))
    out += [a.lamports, bytes(a.data), dict(db.cold_stats)]
    h = db.open_rw("blk", K(6))
    h.account.lamports = 6_001
    db.close_rw(h)
    out.append(db.lamports("blk", K(6)))
    funk.txn_prepare(None, "f1")
    funk.rec_write("f1", K(2), ad.Account(99))
    try:
        db.evict(K(2))
    except cold.ColdEvictError as e:
        out.append(str(e))
    try:
        db.evict(K(77))
    except cold.ColdEvictError as e:
        out.append(str(e))
    funk.txn_publish("blk")
    db.remove(None, K(5))
    out += [db.peek(None, K(5)), dict(db.cold_stats)]
    db.close()
    funk2 = fk.Funk()
    db2 = cold.AccDbCold(funk2, d)
    funk2.txn_prepare(None, "blk")
    out.append([None if (x := db2.peek("blk", K(i))) is None else
                (x.lamports, bytes(x.data)) for i in range(1, 9)])
    db2.close()
    return out


def test_accdb_cold_matches_reference(tmp_path):
    """Eviction by size and by key, the cold fallthrough and promotion
    into the root, handles over a promoted record, the fork-dirty and
    missing-key refusals, the facade's remove, and a restart over the
    same directory."""
    got = []
    for i, (fk, ad, cold) in enumerate(COLD):
        d = str(tmp_path / f"c{i}")
        got.append((_cold_flow(fk, ad, cold, d), volumes(d)))
    assert got[1] == got[0]
    assert got[1][0][0] == 5
