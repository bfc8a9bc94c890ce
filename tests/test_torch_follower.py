"""The follower leg as the system runs it: firedancer_tpu_torch/cfg/
leader_follower.toml (cfg/leader.toml with shredr -> replay -> towersink
on its shred mirror) booted on the CPU at a small synth count, drained
(tools/leader_drain.py: the leader, the slot holding its last
microblock, the shred leg, then the follower), and the bank hash of the
last block on replay_tower held to the JAX package's ShredRecoverCore +
ReplayCore over the same mirrored wires (run there without its PoH
check, which the bank hash does not depend on; the tile's own check
must count no failure). The reference's app/config.py builds the same
TOML into the same links and tiles. Exact: hashes are bytes."""
import dataclasses
import os
import subprocess
import sys

import pytest

from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco.tiles import _synth_genesis
from firedancer_tpu.tiles import replay as jreplay
from firedancer_tpu.tiles import shred as jshred
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco.launch import TopologyRunner
from firedancer_tpu_torch.tools import leader_drain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "firedancer_tpu_torch", "cfg")
FOLLOWER_TOML = os.path.join(CFG, "leader_follower.toml")
FRAMES = 192


def _specs(topo) -> dict:
    return {"links": {n: dataclasses.asdict(s)
                      for n, s in topo.links.items()},
            "tcaches": dict(topo.tcaches),
            "tiles": {n: dataclasses.asdict(s)
                      for n, s in topo.tiles.items()}}


def test_leader_follower_toml_is_leader_toml_with_a_follower_leg():
    """The leader's part is cfg/leader.toml's, unchanged; the follower leg
    consumes shreds_mirror with the leader's identity and takes the
    leader's genesis and hashes_per_tick; the reference's config builds
    the same links and tiles."""
    got = _specs(tconfig.build_topology(tconfig.load_config(FOLLOWER_TOML)))
    leader = _specs(tconfig.build_topology(tconfig.load_config(
        os.path.join(CFG, "leader.toml"))))
    for part in ("links", "tcaches", "tiles"):
        assert {n: got[part][n] for n in leader[part]} == leader[part]
    assert set(got["tiles"]) - set(leader["tiles"]) == \
        set(leader_drain.FOLLOWER_LEG)
    t = got["tiles"]
    assert t["shredr"]["ins"] == [{"link": "shreds_mirror",
                                   "reliable": True}]
    assert t["shredr"]["args"]["leader_pubkey_hex"] == \
        t["shred"]["args"]["identity_hex"]
    assert t["replay"]["args"]["genesis_synth"] == \
        t["bank0"]["args"]["genesis_synth"]
    assert t["replay"]["args"]["hashes_per_tick"] == \
        t["poh"]["args"]["hashes_per_tick"]
    assert _specs(jconfig.build_topology(
        jconfig.load_config(FOLLOWER_TOML))) == got


class _Capture:
    def __init__(self):
        self.frames = []

    def publish(self, frame, sig=0):
        self.frames.append(bytes(frame))

    def credits(self, fseqs):
        return 1 << 30


def test_full_leader_follower_toml_drains_on_the_cpu():
    cfg = tconfig.load_config(FOLLOWER_TOML, overrides={"tile": [
        {"name": "synth", "count": FRAMES, "unique": 64},
        {"name": "verify", "device": "cpu"},
        {"name": "bank0", "device": "cpu"},
        {"name": "replay", "device": "cpu"}]})
    runner = TopologyRunner(tconfig.build_topology(
        cfg, name=f"tff{os.getpid()}").build()).start()
    # every mirrored shred, read as it is published: the shred count
    # grows with the run's wall time, past the ring's depth under load
    tap = leader_drain.LinkTap(runner, "shreds_mirror")
    try:
        runner.wait_running(timeout_s=120)
        runner.wait_idle("synth", "tx", FRAMES, timeout_s=120)
        drops = leader_drain.wait_drained(runner, FRAMES, timeout_s=120)
        leader_drain.close_slot(runner, timeout_s=60)
        m = leader_drain.drain_shred_leg(runner, timeout_s=120,
                                         keep=leader_drain.FOLLOWER_LEG)
        slots = m["poh"]["slots"]
        assert m["shred"]["slots"] == slots
        m = leader_drain.drain_follower(runner, slots, timeout_s=300)
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, (tn, p.exitcode)
        b, r, sr = m["bank0"], m["replay"], m["shredr"]
        assert b["txns"] + drops == FRAMES and b["exec_fail"] == 0
        assert r["slots_replayed"] == slots == sr["slots_done"]
        assert r["poh_fail"] == 0 and r["parse_fail"] == 0
        assert r["txns"] == r["exec_ok"] == b["txns"] > 0
        assert sr["shreds"] == m["shredsink"]["rx"]
        assert m["towersink"]["rx"] == slots
        wires = tap.stop()
        assert len(wires) == m["shredsink"]["rx"]
        blocks = leader_drain.tower_blocks(runner)
    finally:
        tap.close()
        runner.halt()
        runner.close()
    pub = bytes.fromhex(next(t["leader_pubkey_hex"] for t in cfg["tile"]
                             if t["name"] == "shredr"))
    slices = _Capture()
    rec = jshred.ShredRecoverCore(pub, slices, None)
    for w in wires:
        rec.on_shred(w)
    ref = jreplay.ReplayCore(genesis=_synth_genesis(768),
                             hashes_per_tick=64, verify_poh=False)
    for f in slices.frames:
        ref.on_slice(f)
    assert ref.metrics["slots_replayed"] == slots
    assert blocks[-1][0] == slots - 1 == max(ref.bank_hash_of)
    for slot, parent, bid, pid in blocks:
        assert ref.bank_hash_of[slot] == bid, slot
        assert ref.bank_hash_of[parent if slot else -1] == pid, slot


def _run(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run",
         FOLLOWER_TOML, "--interval", "60", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=ROOT))


def test_app_run_boots_leader_follower_toml_on_the_cpu():
    """All thirteen tiles boot and run; the table lists every tile."""
    r = _run("--device", "cpu", "--duration", "2")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for tn in ("synth", "verify0", "verify1", "dedup", "pack", "bank0",
               "poh", "shred", "sign", "shredsink", "shredr", "replay",
               "towersink"):
        assert f"\n{tn} " in r.stdout, tn


def test_app_run_leader_follower_toml_without_a_card_exits_1():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run("--duration", "2")
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
    assert "died" in r.stderr
