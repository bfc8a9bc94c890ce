"""The port's snapshot tiles (firedancer_tpu_torch/tiles/snapshot.py and
their adapters) against the JAX package's: the [snapshot] schema, the
state fingerprint, and the SnapLoader / SnapInserter / SnapDecompress /
ArchiveInserter cores of both packages on in-process rings of their own
runtimes, fed the same files, give the same metrics and restored state;
the loader's three chaos seams (a corrupt frame, a stale offer, a crash
halfway through the file) act alike. Records come from a numpy seed;
every comparison is exact. No process is booted here.

The reference's modules load its native library when imported, so they
are imported inside the `ref` fixture, not at collection."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.funk.funk import Funk
from firedancer_tpu_torch.funk.shmfunk import ShmFunk, WireFunk
from firedancer_tpu_torch.svm.accdb import Account
from firedancer_tpu_torch.tiles import snapshot as tsnap
from firedancer_tpu_torch.utils import checkpt as tck


@pytest.fixture(scope="module")
def ref():
    from firedancer_tpu import runtime as jrt
    from firedancer_tpu.flamenco import snapshot as jfmt
    from firedancer_tpu.funk.funk import Funk as JFunk
    from firedancer_tpu.funk.shmfunk import WireFunk as JWireFunk
    from firedancer_tpu.svm.accdb import Account as JAccount
    from firedancer_tpu.tiles import snapshot as jsnap
    from firedancer_tpu.utils import checkpt as jck
    return SimpleNamespace(rt=jrt, snap=jsnap, fmt=jfmt, ck=jck, Funk=JFunk,
                           WireFunk=JWireFunk, Account=JAccount)


@pytest.fixture()
def wksps(ref):
    """One workspace of each package's runtime."""
    out = []
    for rt, pre in ((ref.rt, "fdtpu"), (trt, "fdtt")):
        out.append(rt.Workspace(f"/{pre}_snt_{os.getpid()}", 1 << 25))
    yield out
    for w in out:
        w.close()
        w.unlink()


def _records(n=200, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = rng.bytes(32)
        if i % 2:
            out.append((key, (int(rng.integers(0, 1 << 50)),
                              rng.bytes(int(rng.integers(0, 300))),
                              rng.bytes(32))))
        else:
            out.append((key, int(rng.integers(0, 1 << 60))))
    return out


def _funk(fcls, acls, recs):
    funk = fcls()
    for k, v in recs:
        funk.rec_write(None, k, acls(*v) if isinstance(v, tuple) else v)
    return funk


def _snapshot(tmp_path, name="snap.ckpt", slot=4, n=200, seed=11):
    path = str(tmp_path / name)
    tck.snapshot_write_atomic(path, _funk(Funk, Account, _records(n, seed)),
                              slot=slot, bank_hash=bytes(range(32)))
    return path


# -- schema and fingerprint ---------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, {}, {"path": "s.ckpt", "every_slots": 4, "min_slot": 2,
               "compress": 0, "chunk": 64}])
def test_normalize_snapshot_as_the_reference(ref, spec):
    assert tsnap.normalize_snapshot(spec) == ref.snap.normalize_snapshot(spec)
    assert tsnap.SNAPSHOT_DEFAULTS == ref.snap.SNAPSHOT_DEFAULTS


@pytest.mark.parametrize("bad,match", [
    ({"pth": "x"}, "did you mean 'path'"), ({"chunk": 63}, "chunk"),
    ({"min_slot": -1}, "min_slot"), ({"path": 3}, "path"), ([1], "table")])
def test_normalize_snapshot_refuses_as_the_reference(ref, bad, match):
    for mod in (tsnap, ref.snap):
        with pytest.raises(ValueError, match=match):
            mod.normalize_snapshot(bad)


def test_state_fingerprint_matches_across_packages_and_backends(ref):
    recs = _records(60, seed=3)
    pf = _funk(Funk, Account, recs)
    sf = ShmFunk(rec_max=1024, txn_max=16, heap_sz=1 << 20)
    try:
        for k, v in recs:
            sf.rec_write(None, k, Account(*v) if isinstance(v, tuple) else v)
        sf.rec_write(None, tck.RESTORE_MARKER_KEY, (4, bytes(32)))
        want = ref.snap.state_fingerprint(_funk(ref.Funk, ref.Account, recs))
        assert tsnap.state_fingerprint(pf) == tsnap.state_fingerprint(sf) \
            == want
    finally:
        sf.close(unlink=True)


# -- the cores on rings -------------------------------------------------------

def _pipeline(rt, snap_mod, w, path, chunk=1024, depth=32, **kw):
    ring = rt.Ring.create(w, depth=depth, mtu=1280)
    ld = snap_mod.SnapLoader(path, ring, [], chunk=chunk)
    sn = snap_mod.SnapInserter(ring, **kw)
    return ld, sn


def _run(ld, sn, max_polls=10_000):
    for _ in range(max_polls):
        ld.poll_once()
        sn.poll_once()
        if ld.metrics["done"] and not sn.poll_once():
            return
    raise AssertionError("stream never ended")


def test_loader_and_inserter_cores_match_reference(ref, wksps, tmp_path):
    """The checkpoint file through SnapLoader -> SnapInserter into a
    private funk, in both packages: the stream spans many frags (the
    SOM/EOM path), equal metrics and restored records."""
    path = _snapshot(tmp_path)
    assert os.path.getsize(path) > 16 * 1024
    got = []
    for w, rt, mod in ((wksps[0], ref.rt, ref.snap), (wksps[1], trt, tsnap)):
        ld, sn = _pipeline(rt, mod, w, path)
        _run(ld, sn)
        got.append((dict(ld.metrics), dict(sn.metrics),
                    {k: getattr(v, "lamports", v)
                     for k, v in sn.funk.root_items().items()}))
    assert got[0] == got[1]
    assert got[1][1]["restored"] == 1 and got[1][1]["accounts"] == 200 \
        and got[1][1]["slot"] == 4 and got[1][0]["frags"] > 16


def test_inserter_into_the_shm_store_installs_the_marker(ref, wksps,
                                                         tmp_path):
    """snapin's adapter over a plan's carved store: the restore lands in
    the shared store and is followed by the restore marker (slot, bank
    hash), and the fingerprint excludes the marker; the reference's
    adapter over its own store ends the same."""
    path = _snapshot(tmp_path, n=50)
    got = []
    for w, rt, tiles, wf in ((wksps[0], ref.rt, None, ref.WireFunk),
                             (wksps[1], trt, ttiles, WireFunk)):
        st = rt.Store(w, rec_max=1024, txn_max=16, heap_sz=1 << 20)
        fk = {"backend": "shm", "rec_max": 1024, "txn_max": 16,
              "heap_mb": 1, "off": st.off, "heap_sz": 1 << 20}
        ring = rt.Ring.create(w, depth=32, mtu=1280)
        if tiles is None:
            from firedancer_tpu.disco import tiles as tiles
        ctx = SimpleNamespace(
            tile_name="snapin", wksp=w,
            plan={"links": {"s": {"mtu": 1280}}, "funk": fk,
                  "snapshot": {"min_slot": 4}},
            in_rings={"s": ring}, out_rings={}, out_fseqs={}, in_seq0={})
        sn = tiles.REGISTRY["snapin"](ctx, {})
        mod = ref.snap if tiles is not ttiles else tsnap
        _run(mod.SnapLoader(path, ring, [], chunk=1024), sn)
        shared = wf.from_plan(w, fk)
        m = sn.metrics_items()
        # restore_us is the port adapter's own metric
        got.append(({k: v for k, v in m.items() if k != "restore_us"},
                    shared.rec_query(None, tck.RESTORE_MARKER_KEY),
                    len(shared.root_items())))
    assert got[0] == got[1]
    assert got[1][1] == (4, bytes(range(32))) and got[1][2] == 51


@pytest.mark.parametrize("fault", ["corrupt_checkpt_frame",
                                   "stale_snapshot_offer"])
def test_loader_chaos_seams_refused_alike(ref, wksps, tmp_path, fault):
    """The two seams armed as the adapters' on_chaos arms them: the
    corrupt byte fails the integrity check, the stale offer the min_slot
    gate; both inserters raise their package's CheckptError and install
    nothing, and the loaders' metrics agree."""
    path = _snapshot(tmp_path, n=50)
    stale = _snapshot(tmp_path, "stale.ckpt", slot=2, n=30, seed=4)
    got = []
    for w, rt, mod, ck in ((wksps[0], ref.rt, ref.snap, ref.ck),
                           (wksps[1], trt, tsnap, tck)):
        ld, sn = _pipeline(rt, mod, w, path, min_slot=4)
        if fault == "corrupt_checkpt_frame":
            ld._corrupt_seed = 5
        else:
            ld.offer(stale)
        with pytest.raises(ck.CheckptError) as ei:
            _run(ld, sn)
        got.append((str(ei.value), dict(ld.metrics), sn.funk,
                    dict(sn.metrics)))
    assert got[0][0] == got[1][0] and got[0][1] == got[1][1]
    assert got[0][3] == got[1][3] and got[1][2] is None
    assert got[1][1]["corrupted" if fault == "corrupt_checkpt_frame"
                     else "offers"] == (1 if fault[0] == "c" else 2)


class _Exit(Exception):
    pass


def test_loader_crash_seam_exits_halfway_alike(ref, wksps, tmp_path,
                                               monkeypatch):
    """crash_mid_snapshot: the loader leaves with code 71 once its offset
    passes half the file, after the same frags in both packages (the
    process exit replaced by an exception here)."""
    path = _snapshot(tmp_path, n=50)

    def fake_exit(code):
        raise _Exit(code)
    monkeypatch.setattr(os, "_exit", fake_exit)
    got = []
    for w, rt, mod in ((wksps[0], ref.rt, ref.snap), (wksps[1], trt, tsnap)):
        ring = rt.Ring.create(w, depth=512, mtu=1280)
        ld = mod.SnapLoader(path, ring, [], chunk=128)
        ld._crash_at = max(1, ld.size // 2)
        with pytest.raises(_Exit) as ei:
            for _ in range(1000):
                ld.poll_once()
        got.append((ei.value.args[0], dict(ld.metrics), ring.seq))
    assert got[0] == got[1] and got[1][0] == 71
    assert 0 < got[1][1]["bytes"] < got[1][1]["total_bytes"]


def test_snapld_adapter_routes_the_three_seams(wksps, tmp_path):
    """SnapLdAdapter.on_chaos arms the core as the reference's does."""
    path = _snapshot(tmp_path, n=50)
    stale = _snapshot(tmp_path, "stale.ckpt", slot=2, n=30, seed=4)
    ring = trt.Ring.create(wksps[1], depth=32, mtu=1280)
    ctx = SimpleNamespace(
        tile_name="snapld", wksp=wksps[1],
        plan={"links": {"s": {"mtu": 1280}},
              "snapshot": {"path": path, "chunk": 256}},
        in_rings={}, out_rings={"s": ring}, out_fseqs={"s": []}, in_seq0={})
    ad = ttiles.REGISTRY["snapld"](ctx, {"stale_path": stale})
    assert ad.tile.chunk == 256 and ad.tile.size == os.path.getsize(path)
    ad.on_chaos({"action": "corrupt_checkpt_frame", "seed": 9})
    assert ad.tile._corrupt_seed == 9
    ad.on_chaos({"action": "crash_mid_snapshot"})
    assert ad.tile._crash_at == ad.tile.size // 2
    ad.on_chaos({"action": "stale_snapshot_offer"})
    assert ad.metrics_items()["offers"] == 2 \
        and ad.tile.size == os.path.getsize(stale)
    assert set(ttiles.SnapLdAdapter.METRICS) <= set(ad.metrics_items())


# -- the archive format's tile chain -----------------------------------------

def test_decompress_and_archive_inserter_cores_match_reference(
        ref, wksps, tmp_path):
    """The real archive through SnapLoader -> SnapDecompress ->
    ArchiveInserter in both packages (the port's lattice on the CPU):
    equal metrics, lattice_ok, and equal restored accounts; a tampered
    archive fails both, nothing installed."""
    pytest.importorskip("zstandard")
    from firedancer_tpu_torch.flamenco import snapshot as tfmt
    rng = np.random.default_rng(8)
    accts = [(rng.bytes(32), (int(rng.integers(1, 1 << 40)),
                              rng.bytes(int(rng.integers(0, 170))),
                              rng.bytes(32))) for _ in range(150)]
    path = str(tmp_path / "a.tar.zst")
    tfmt.write_snapshot_archive(path, 11, _funk(Funk, Account, accts),
                                accounts_per_vec=64, device="cpu")
    from firedancer_tpu_torch.tools import catchup
    catchup.tamper_archive(path, path + ".bad", 11)
    for p, ok in ((path, True), (path + ".bad", False)):
        got = []
        for w, rt, mod, kw in ((wksps[0], ref.rt, ref.snap, {}),
                               (wksps[1], trt, tsnap, {"device": "cpu"})):
            a = rt.Ring.create(w, depth=64, mtu=3000)
            b = rt.Ring.create(w, depth=256, mtu=4096)
            ld = mod.SnapLoader(p, a, [], chunk=3000)
            dc = mod.SnapDecompress(a, b, [])
            ai = mod.ArchiveInserter(b, **kw)
            err = None
            try:
                for _ in range(10_000):
                    n = ld.poll_once() + dc.poll_once() + ai.poll_once()
                    if not n and ld.metrics["done"]:
                        break
            except RuntimeError as e:
                err = str(e)
            got.append((err, dict(ld.metrics), dict(dc.metrics),
                        dict(ai.metrics),
                        {k: (v.lamports, v.data, v.owner)
                         for k, v in ai.funk.root_items().items()}))
        assert got[0] == got[1]
        assert got[1][3]["lattice_ok"] == int(ok)
        assert (got[1][0] is None) == ok
        assert got[1][4] == ({k: v for k, v in accts} if ok else {})
