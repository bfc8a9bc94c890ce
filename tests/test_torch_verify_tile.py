"""The port's VerifyTile (device="cpu": plain versions of both kernels)
against the reference VerifyTile over real shm rings, driven in-process
as tests/test_verify_tile.py drives the reference. Same frames, same
dedup seed, separate workspaces: the out-ring payloads must be byte-equal
and in the same order, and the metrics dicts equal."""
import os

import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.tiles import synth as jsynth
from firedancer_tpu.tiles.verify import VerifyTile as RefVerifyTile
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.tiles import synth as tsynth
from firedancer_tpu_torch.tiles.verify import VerifyTile

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


@pytest.mark.parametrize("kw", [{"mode": "bulk_prefilter"}, {"devices": 2},
                                {"chaos": {"fail_dispatch": 1}},
                                {"trace": object()}, {"coalesce_us": 50.0}])
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
