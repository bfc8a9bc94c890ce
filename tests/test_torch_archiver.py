"""The port's archiver and playback (firedancer_tpu_torch/tiles/
archiver.py and their adapters) against the JAX package's, in process on
rings of each package's runtime: the same frags (synth's signed txns
from a seed, a multi-frag SOM/EOM message, a lapped reader) record to
byte-equal files that either package's CheckptReader reads, and playback
of a file republishes the same payloads, sigs and ctl bits in both. No
process is booted here.

The reference's modules load its native library when imported, so they
are imported inside the `ref` fixture, not at collection."""
import os
from types import SimpleNamespace

import pytest

from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.tiles import archiver as tarch
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.utils import checkpt as tck


@pytest.fixture(scope="module")
def ref():
    from firedancer_tpu import runtime as jrt
    from firedancer_tpu.disco import tiles as jtiles
    from firedancer_tpu.tiles import archiver as jarch
    from firedancer_tpu.utils import checkpt as jck
    return SimpleNamespace(rt=jrt, tiles=jtiles, arch=jarch, ck=jck)


@pytest.fixture()
def wksps(ref):
    out = [ref.rt.Workspace(f"/fdtpu_arc_{os.getpid()}", 1 << 24),
           trt.Workspace(f"/fdtt_arc_{os.getpid()}", 1 << 24)]
    yield out
    for w in out:
        w.close()
        w.unlink()


FRAGS = [(t, i, 0) for i, t in enumerate(make_signed_txns(24, seed=13))] \
    + [(b"a" * 300, 99, 1), (b"b" * 300, 100, 0), (b"c" * 7, 101, 2)]


def _record(rt, arch, w, path, frags, depth=64, polls=1):
    ring = rt.Ring.create(w, depth=depth, mtu=1280)
    rec = arch.ArchiveWriter(ring, path)
    for j, (p, sig, ctl) in enumerate(frags):
        ring.publish(p, sig=sig, ctl=ctl)
        if polls and j % polls == 0:
            rec.poll_once()
    while rec.poll_once():
        pass
    rec.close()
    return dict(rec.metrics)


def _play(rt, arch, w, path, depth=64):
    ring = rt.Ring.create(w, depth=depth, mtu=1280)
    play = arch.ArchivePlayback(path, ring, [])
    out, seq = [], 0
    while True:
        n = play.poll_once()
        while True:
            rc, frag = ring.consume(seq)
            if rc != 0:
                break
            out.append((bytes(ring.payload(frag)), frag.sig, frag.ctl))
            seq += 1
        if not n and play.metrics["done"]:
            return out, dict(play.metrics)


def test_recordings_are_byte_equal_and_cross_read(ref, wksps, tmp_path):
    paths, metrics = [], []
    for w, rt, arch, name in ((wksps[0], ref.rt, ref.arch, "j.arch"),
                              (wksps[1], trt, tarch, "t.arch")):
        paths.append(str(tmp_path / name))
        metrics.append(_record(rt, arch, w, paths[-1], FRAGS))
    assert metrics[0] == metrics[1] and metrics[1]["frags"] == len(FRAGS)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    with open(paths[1], "rb") as f:
        frames = list(ref.ck.CheckptReader(f).frames())
    with open(paths[0], "rb") as f:
        assert list(tck.CheckptReader(f).frames()) == frames
    assert [(fr[22:], int.from_bytes(fr[8:16], "little"),
             int.from_bytes(fr[16:18], "little")) for fr in frames] == FRAGS


def test_playback_republishes_the_same_frags(ref, wksps, tmp_path):
    path = str(tmp_path / "t.arch")
    _record(trt, tarch, wksps[1], path, FRAGS)
    got = [_play(ref.rt, ref.arch, wksps[0], path),
           _play(trt, tarch, wksps[1], path)]
    assert got[0] == got[1]
    assert got[1][0] == FRAGS and got[1][1]["frags"] == len(FRAGS)


def test_a_lapped_recorder_resyncs_alike(ref, wksps, tmp_path):
    """A producer that laps the recorder's ring: both skip to the oldest
    live frag and count the same overruns."""
    frags = [(bytes([i]) * 40, i, 0) for i in range(100)]
    got = []
    for w, rt, arch, name in ((wksps[0], ref.rt, ref.arch, "j.arch"),
                              (wksps[1], trt, tarch, "t.arch")):
        path = str(tmp_path / name)
        m = _record(rt, arch, w, path, frags, depth=16, polls=0)
        got.append((m, open(path, "rb").read()))
    assert got[0] == got[1] and got[1][0]["overruns"] > 0


def test_adapters_record_and_play_back(ref, wksps, tmp_path):
    """ArchiverAdapter and PlaybackAdapter over each package's rings: the
    same metrics, and the adapter's recording played by the reference's
    adapter gives the frags back."""
    path = str(tmp_path / "a.arch")
    ring = trt.Ring.create(wksps[1], depth=64, mtu=1280)
    rec = ttiles.REGISTRY["archiver"](SimpleNamespace(
        tile_name="rec", plan={"links": {"i": {"mtu": 1280}}},
        in_rings={"i": ring}, out_rings={}, out_fseqs={}, in_seq0={}),
        {"path": path})
    for p, sig, ctl in FRAGS:
        ring.publish(p, sig=sig, ctl=ctl)
    rec.poll_once()
    assert rec.in_seqs() == {"i": len(FRAGS)}
    rec.on_halt()
    assert rec.metrics_items() == {"frags": len(FRAGS), "overruns": 0,
                                   "bytes": sum(len(p) for p, _, _ in FRAGS)}
    got = []
    for w, rt, tiles in ((wksps[0], ref.rt, ref.tiles),
                         (wksps[1], trt, ttiles)):
        out = rt.Ring.create(w, depth=64, mtu=1280)
        play = tiles.REGISTRY["playback"](SimpleNamespace(
            tile_name="play", plan={"links": {"o": {"mtu": 1280}}},
            in_rings={}, out_rings={"o": out}, out_fseqs={"o": []},
            in_seq0={}), {"path": path})
        while play.poll_once():
            pass
        frames = [(bytes(out.payload(out.consume(s)[1])),
                   out.consume(s)[1].sig) for s in range(len(FRAGS))]
        got.append((frames, play.metrics_items()))
    assert got[0] == got[1]
    assert got[1][0] == [(p, sig) for p, sig, _ in FRAGS]
    assert got[1][1]["done"] == 1
