"""The port's VerifyTile (device="cpu": plain versions of every kernel)
against the reference VerifyTile over real shm rings, driven in-process
as tests/test_verify_tile.py drives the reference. Same frames, same
dedup seed, separate workspaces: the out-ring payloads must be byte-equal
and in the same order, and the metrics dicts equal.

The bulk_prefilter scenarios (the flood front door of tests/test_flood.py)
give the reference tile the Python-int RLC oracle of tests/test_flood.py
(its JAX RLC graph takes minutes to compile on the CPU) and the port its
own plain RLC; both get the same rigged z draw, and the ingest-saturation
window is forced open where a scenario needs it. Metrics are compared
without `rlc_ns`, a duration."""
import os

import numpy as np
import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.tiles import synth as jsynth
from firedancer_tpu.tiles.verify import VerifyTile as RefVerifyTile
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.tiles import synth as tsynth
from firedancer_tpu_torch.tiles.verify import VerifyTile
from firedancer_tpu_torch.utils import chaos
from test_flood import host_rlc

BATCH = 16
SEED = bytes(range(16))


def _frames():
    """Valid txns, duplicates, corrupted signatures (each with a changed
    message so its dedup tag is its own), a duplicate of a corrupted one
    and an unparseable payload."""
    txns = jsynth.make_signed_txns(24, seed=3)
    assert txns == tsynth.make_signed_txns(24, seed=3)
    frames = list(txns) + txns[:6]
    for i in (2, 9, 17):
        bad = bytearray(txns[i])
        bad[3 + i] ^= 1                # inside signature 0
        bad[-1] ^= 1                   # message, so the tag differs
        frames.append(bytes(bad))
    frames.append(frames[-1])
    frames.append(b"\xff\x00garbage")
    frames += txns[20:24]
    return frames


def _drive(rt, tile_cls, frames, name, **kw):
    w = rt.Workspace(f"/fdtt_{name}_{os.getpid()}", 1 << 24)
    try:
        in_ring = rt.Ring.create(w, depth=128, mtu=1280)
        out_ring = rt.Ring.create(w, depth=128, mtu=1280)
        tile = tile_cls(in_ring, out_ring, rt.Tcache(w, depth=512),
                        batch=BATCH, dedup_seed=SEED, **kw)
        for i, f in enumerate(frames):
            in_ring.publish(f, sig=i)
        while tile.poll_once():
            pass
        tile.flush()
        out, seq = [], 0
        while True:
            rc, frag = out_ring.consume(seq)
            if rc != 0:
                break
            out.append(bytes(out_ring.payload(frag)))
            seq += 1
        return out, dict(tile.metrics)
    finally:
        w.close()
        w.unlink()


def test_port_tile_matches_reference_tile():
    frames = _frames()
    want_out, want_m = _drive(jrt, RefVerifyTile, frames, "ref")
    got_out, got_m = _drive(trt, VerifyTile, frames, "port", device="cpu")
    assert got_out == want_out
    assert got_m == want_m
    # the duplicate of a corrupted frame is verified (and fails) too: a
    # failed txn never enters the tcache
    assert want_m["verify_fail"] == 4 and want_m["parse_fail"] == 1
    assert want_m["dedup_drop"] == 10 and want_m["tx"] == 24


def _seeded_draw(seed):
    rng = np.random.default_rng(seed)
    return lambda n: rng.integers(0, 256, (n, 16), dtype=np.uint8)


def _mod8_draw(n):
    """z = 8 on every lane: z = 0 mod 8, the draw under which the
    cofactored equation cannot see a pure 8-torsion residual."""
    z = np.zeros((n, 16), np.uint8)
    z[:, 0] = 8
    return z


def _publish(ring, frames, first=0):
    for i, f in enumerate(frames):
        ring.publish(f, sig=first + i)


def _run(rt, tile_cls, name, script, draw, **kw):
    """Build a bulk_prefilter tile with the z draw `draw()`, run
    script(tile, in_ring), then drain; -> (out frames, metrics without
    rlc_ns)."""
    w = rt.Workspace(f"/fdtt_{name}_{os.getpid()}", 1 << 24)
    try:
        in_ring = rt.Ring.create(w, depth=128, mtu=1280)
        out_ring = rt.Ring.create(w, depth=128, mtu=1280)
        tile = tile_cls(in_ring, out_ring, rt.Tcache(w, depth=512),
                        batch=BATCH, dedup_seed=SEED, mode="bulk_prefilter",
                        **kw)
        if tile_cls is RefVerifyTile:
            tile._rlc_fn = host_rlc
        tile._draw_z = draw()
        script(tile, in_ring)
        while tile.poll_once():
            pass
        tile.flush()
        out, seq = [], 0
        while True:
            rc, frag = out_ring.consume(seq)
            if rc != 0:
                break
            out.append(bytes(out_ring.payload(frag)))
            seq += 1
        m = dict(tile.metrics)
        del m["rlc_ns"]
        return out, m
    finally:
        w.close()
        w.unlink()


def _hot(tile):
    tile._hot_until = 1 << 62          # ingest-saturation window open


def _forged_flood(tile, ring):
    _hot(tile)
    _publish(ring, chaos.attack_frames("flood_forged", 8, seed=3))


def _torsion_batch(tile, ring):
    _hot(tile)
    _publish(ring, chaos.attack_frames("flood_torsion", 8, seed=21))


def _mixed_chunk(tile, ring):
    _hot(tile)
    _publish(ring, chaos.attack_frames("flood_forged", 4, seed=5))
    _publish(ring, tsynth.make_signed_txns(4, seed=41), first=100)


def _coalesced_trickle(tile, ring):
    """Bursts of 5 held in the window until a chunk's lanes fill (the
    filling gather takes 1 frame, and a full chunk engages the
    prefilter); the rest is held, then flushed by narrowing the window."""
    txns = tsynth.make_signed_txns(24, seed=43)
    for k in (0, 5, 10):
        _publish(ring, txns[k:k + 5], first=k)
        assert tile.poll_once() == 5
    assert tile._hold_n == 15 and tile.metrics["batches"] == 0
    _publish(ring, txns[15:20], first=15)
    assert tile.poll_once() == 1 and tile.metrics["batches"] == 1
    assert tile.poll_once() == 4 and tile._hold_n == 4
    tile._hot_until = 0     # closed: the remainders go straight to strict
    tile.set_coalesce_ns(0)
    assert tile._hold_n == 0 and tile.metrics["batches"] == 2
    _publish(ring, txns[20:], first=20)


@pytest.mark.parametrize("scenario,draw,kw,want", [
    (_forged_flood, lambda: _seeded_draw(1), {},
     dict(rlc_shed=8, tx=0, batches=0)),
    (_forged_flood, lambda: _seeded_draw(1), {"prefilter_shed": False},
     dict(rlc_batches=1, rlc_shed=0, verify_fail=8, batches=1)),
    (_torsion_batch, lambda: _mod8_draw, {},
     dict(rlc_pass=1, rlc_shed=0, verify_fail=8, tx=0)),
    (_mixed_chunk, lambda: _seeded_draw(2), {},
     dict(rlc_batches=3, rlc_shed=0, verify_fail=4, tx=4)),
    (_coalesced_trickle, lambda: _seeded_draw(3), {"coalesce_us": 1e7},
     dict(rlc_batches=1, rlc_pass=1, tx=24, batches=3)),
], ids=["forged_flood", "forged_flood_no_shed", "torsion_batch",
        "mixed_chunk", "coalesced_trickle"])
def test_prefilter_matches_reference_tile(monkeypatch, scenario, draw, kw,
                                          want):
    monkeypatch.setenv("FDTPU_VERIFY_SKIP_RLC_WARMUP", "1")
    want_out, want_m = _run(jrt, RefVerifyTile, "pref", scenario, draw, **kw)
    got_out, got_m = _run(trt, VerifyTile, "porf", scenario, draw,
                          device="cpu", **kw)
    assert got_out == want_out
    assert got_m == want_m
    assert {k: got_m[k] for k in want} == want


@pytest.mark.parametrize("action", ["flood_forged", "flood_torsion",
                                    "flood_dup"])
def test_attack_frames_match_reference(action):
    from firedancer_tpu.utils.chaos import attack_frames
    assert chaos.attack_frames(action, 10, seed=4) == \
        attack_frames(action, 10, seed=4)


@pytest.mark.parametrize("action", ["flood_malformed_quic"])
def test_unported_floods_raise(action):
    """Raised until ROADMAP.md queue A item 3b ported the QUIC door;
    now the flood's frames are the reference's."""
    from firedancer_tpu.utils.chaos import attack_frames
    assert chaos.attack_frames(action, 12, seed=4) == \
        attack_frames(action, 12, seed=4)
    assert chaos.attack_frames(action, 0) == []


@pytest.mark.parametrize("kw", [{"devices": 2}])
def test_out_of_scope_options_raise(kw):
    w = trt.Workspace(f"/fdtt_oos_{os.getpid()}", 1 << 20)
    try:
        ring = trt.Ring.create(w, depth=8, mtu=1280)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            VerifyTile(ring, ring, trt.Tcache(w, depth=64), batch=BATCH,
                       device="cpu", **kw)
    finally:
        w.close()
        w.unlink()


def test_prefilter_warmup_failure_raises(monkeypatch):
    """No silent switch to strict mode: when the RLC path cannot run at
    boot, the tile does not come up."""
    from firedancer_tpu_torch.ops import cuda_msm

    def broken(*a, **k):
        raise RuntimeError("nvcc failed for ed25519_msm.cu")
    monkeypatch.setattr(cuda_msm, "rlc_verify_batch", broken)
    w = trt.Workspace(f"/fdtt_wf_{os.getpid()}", 1 << 20)
    try:
        ring = trt.Ring.create(w, depth=8, mtu=1280)
        with pytest.raises(RuntimeError, match="ed25519_msm"):
            VerifyTile(ring, ring, trt.Tcache(w, depth=64), batch=BATCH,
                       mode="bulk_prefilter", device="cpu")
    finally:
        w.close()
        w.unlink()
