"""The voting catch-up follower as the system runs it, on the CPU: the
port's firedancer_tpu_torch/cfg/follower.toml (the copy of the JAX
package's cfg/follower-demo.toml: sock -> shred recover, snapld -> snapin
restoring the genesis checkpoint into the shm store, replay behind its
restore gate over two exec shards, tower -> send -> sign) beside the
leader app.dev boots (cfg/leader.toml with the same genesis in bank0) +
cfg/cluster.toml, booted by tools/cluster.py at
tests/test_torch_nonleader.py's size (24 synth txns, 16 hashes a tick, 4
ticks a slot; a tick every 40 ms), no slot dropped. The genesis is the
port's `app.genesis` CLI's at the demo's `--validators 1 --user-accounts
16`.

Held to the JAX package: its own `build_genesis` checkpoint, restored by
its `snapshot_restore_into` and seeded by its ReplayCore's restore gate,
replays the leader's complete slices (the shred mirror, tapped and
recovered by its ShredRecoverCore) over its InlineFanout; every block
frame's bank hash is its bank hash of that slot (replayed there without
its PoH check, which the bank hash does not depend on; the tile's own
check counts no failure), every vote passes `check_votes` against it, and
the snapshot the follower's replay wrote restores through its
`snapshot_restore_into` to its store at that slot. The follower's TOML
builds, every key accepted, into the reference's links and tiles. Every
wait is on a metric, never on a clock. Exact: hashes and stores are
compared whole."""
import dataclasses
import io
import os

import pytest

from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.tiles.tower import parse_block
from firedancer_tpu_torch.tools import cluster as tcluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 24
HPT, TICKS = 16, 4
WAIT_S = 300.0
# tests/test_torch_nonleader.py's poh cadence: 40 ms a tick
POH_LAZY_NS = 40_000_000
GENESIS_ARGS = ("--validators", "1", "--user-accounts", "16")


def _specs(topo) -> dict:
    return {"links": {n: dataclasses.asdict(s)
                      for n, s in topo.links.items()},
            "tiles": {n: (s.kind, s.ins, s.outs)
                      for n, s in topo.tiles.items()}}


def test_follower_toml_is_the_references_demo():
    """cfg/follower.toml loads through app.config with every key
    accepted, and builds the links and tiles (kinds, ins, outs) the
    reference's config builds from cfg/follower-demo.toml, with the
    same [funk], [replay] and [snapshot] less its path; replay, exec and
    snapin take device "cuda"."""
    from firedancer_tpu.app import config as jconfig
    cfg = tconfig.load_config(tcluster.FOLLOWER_TOML)
    got = tconfig.build_topology(cfg)
    jcfg = jconfig.load_config(os.path.join(ROOT, "cfg",
                                            "follower-demo.toml"))
    want = jconfig.build_topology(jcfg)
    assert _specs(got) == _specs(want)
    for sec in ("funk", "replay"):
        assert cfg[sec] == jcfg[sec], sec
    drop = lambda d: {k: v for k, v in d.items() if k != "path"}
    assert drop(cfg["snapshot"]) == drop(jcfg["snapshot"])
    assert cfg["snapshot"]["every_slots"] == 64
    assert cfg["replay"]["exec_tile_cnt"] == 2 \
        and cfg["replay"]["verify_poh"] is True
    for t in cfg["tile"]:
        want_dev = t["kind"] in tcluster.FOLLOWER_DEVICE_TILES
        assert (t.get("device") == "cuda") == want_dev, t["name"]
    # the pair's ports: turbine in on 9910, votes out to 9920
    leader = tconfig.load_config(*tcluster.LEADER_TOMLS)
    shred = next(t for t in leader["tile"] if t["name"] == "shred")
    tiles = {t["name"]: t for t in cfg["tile"]}
    assert shred["cluster"][0]["addr"] == \
        f"127.0.0.1:{tiles['sock']['port']}"
    assert tiles["send"]["dest"] == "127.0.0.1:9920"
    assert tiles["shred"]["leader_pubkey_hex"] == shred["identity_hex"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two nodes on the CPU, drained; -> their record."""
    from firedancer_tpu_torch.app.genesis import main as genesis_main
    from firedancer_tpu_torch.utils.checkpt import snapshot_restore_into
    from firedancer_tpu_torch.funk.funk import Funk
    tmp = tmp_path_factory.mktemp("follower")
    ckpt = str(tmp / "genesis.ckpt")
    assert genesis_main([ckpt, *GENESIS_ARGS]) == 0
    c = tcluster.Cluster(
        "tfd", "cpu", genesis_ckpt=ckpt,
        leader_tiles=[{"name": "synth", "count": FRAMES, "unique": FRAMES},
                      {"name": "poh", "hashes_per_tick": HPT,
                       "ticks_per_slot": TICKS, "lazy_ns": POH_LAZY_NS}],
        nonleader_tiles=[{"name": "replay", "hashes_per_tick": HPT}])
    try:
        c.start(boot_timeout_s=WAIT_S)
        # poh runs on to slot 64 at least: the replay's first snapshot
        d = c.drain(FRAMES, WAIT_S)
        c.wait(lambda: c.b.metrics("tower")["votes_out"] >= 1, WAIT_S,
               "a vote")
        c.wait(lambda: len(c.votes()) >= 1, WAIT_S, "a vote datagram")
        c.wait(lambda: c.b.metrics("replay")["snapshots"] >= 1, WAIT_S,
               "a snapshot")
        # every tile of both nodes exits 0 (Cluster.stop asserts it)
        got = c.stop()
        with open(c.snapshot_path, "rb") as f:
            snap = f.read()
        leader_cfg = c.a_cfg
    finally:
        c.close()
    port_store = Funk()
    snap_slot, snap_hash, _ = snapshot_restore_into(port_store,
                                                    io.BytesIO(snap))
    return {"drain": d, "got": got, "snap": snap, "snap_slot": snap_slot,
            "snap_hash": snap_hash, "ckpt": ckpt,
            "leader_cfg": leader_cfg, "votes": list(c.vote_log)}


@pytest.fixture(scope="module")
def ref(run):
    """The JAX package's oracle: its genesis (byte for byte the
    checkpoint the follower restored), restored and seeded as its
    follower would be, replaying the leader's mirrored slices; its store
    kept at the snapshot's slot."""
    from firedancer_tpu.app.genesis import build_genesis
    from firedancer_tpu.funk.funk import Funk
    from firedancer_tpu.tiles.replay import InlineFanout, ReplayCore
    from firedancer_tpu.tiles.shred import ShredRecoverCore, parse_slice
    from firedancer_tpu.utils.checkpt import (RESTORE_MARKER_KEY,
                                              funk_checkpt,
                                              snapshot_restore_into)
    from tests.test_repair_replay import _CaptureRing
    gfunk, _ = build_genesis(1, 16)
    buf = io.BytesIO()
    funk_checkpt(gfunk, buf)
    with open(run["ckpt"], "rb") as f:
        assert f.read() == buf.getvalue()
    funk = Funk()
    slot, bank_hash, _ = snapshot_restore_into(funk,
                                               io.BytesIO(buf.getvalue()))
    assert (slot, bank_hash) == (0, bytes(32))
    core = ReplayCore(funk=funk, fanout=InlineFanout(funk),
                      hashes_per_tick=HPT, verify_poh=False,
                      wait_restore=True)
    funk.rec_write(None, RESTORE_MARKER_KEY, (slot, bank_hash))
    assert core.check_restore()
    mirror = _CaptureRing()
    rec = ShredRecoverCore(tcluster.Cluster.leader_identity(), mirror, None)
    for w in run["got"]["shreds_mirror"]:
        rec.on_shred(w)
    assert rec.metrics["parse_fail"] == 0
    slices = [f for f, _ in mirror.frames]
    cut = run["snap_slot"]
    for f in slices:
        if parse_slice(f)[0] <= cut:
            core.on_slice(f)
    store = dict(funk.root_items())
    store.pop(RESTORE_MARKER_KEY, None)
    for f in slices:
        if parse_slice(f)[0] > cut:
            core.on_slice(f)
    slot0 = sum(len(ts) for s, e in _slot_entries(slices) if s == 0
                for _, _, ts in e)
    return {"core": core, "store": store, "slot0_txns": slot0}


def _slot_entries(slices):
    """-> [(slot, entries)] of complete slices, the reference's parse."""
    from firedancer_tpu.tiles.shred import parse_entry_batch, parse_slice
    acc, out = {}, []
    for f in slices:
        slot, _, fin, payload = parse_slice(f)
        acc[slot] = acc.get(slot, b"") + payload
        if fin:
            out.append((slot, parse_entry_batch(acc.pop(slot))))
    return out


def test_follower_restores_the_genesis_and_replays_every_txn(run, ref):
    """snapin restored the legacy checkpoint as slot 0, the replay's gate
    folded it (restore_slot 0), and every txn the leader executed after
    slot 0 was replayed with status ok over both exec shards: no PoH
    failure, no divergence, no parse failure."""
    la = run["got"]["metrics"]["leader"]
    fm = run["got"]["metrics"]["follower"]
    r, sn = fm["replay"], fm["snapin"]
    assert sn["restored"] == 1 and sn["slot"] == 0 \
        and sn["stream_err"] == 0 and sn["accounts"] == 19, sn
    assert r["restore_slot"] == 0 and r["restore_fold_us"] > 0, r
    assert la["bank0"]["txns"] + run["drain"]["dropped"] == FRAMES
    assert la["bank0"]["exec_fail"] == 0
    # the replay never runs its restore slot (the reference's gate too)
    want = la["bank0"]["txns"] - ref["slot0_txns"]
    assert r["txns"] == r["exec_ok"] == want > 0, (r, ref["slot0_txns"])
    assert r["slots_replayed"] >= run["drain"]["replayed"] >= 64
    for key in ("poh_fail", "divergent_slot", "parse_fail", "exec_fail"):
        assert r[key] == 0, (key, r)
    assert fm["exec0"]["txns"] > 0 and fm["exec1"]["txns"] > 0
    assert fm["exec0"]["txns"] + fm["exec1"]["txns"] == r["txns"]
    assert ref["core"].metrics["txns"] == r["txns"]


def test_follower_bank_hashes_are_the_references(run, ref):
    """Every block frame on replay_tower: slot s's bank hash and its
    parent's are the JAX package's ReplayCore's, from slot 1 on (slot
    0's parent is the restore's zero hash)."""
    blocks = [parse_block(f) for f in run["got"]["replay_tower"]]
    replayed = [s for s, *_ in blocks]
    assert replayed == list(range(1, len(blocks) + 1))
    want = ref["core"].bank_hash_of
    for slot, parent, bid, pid in blocks:
        assert want[slot] == bid, slot
        assert want[parent] == pid, slot
    assert want[0] == bytes(32)


def test_follower_votes_for_replayed_bank_hashes(run, ref):
    """Every vote datagram is a TowerSync signed by the follower's
    identity (the demo's, not genesis validator 0's) for a replayed
    slot's bank hash."""
    fm = run["got"]["metrics"]["follower"]
    blocks = [parse_block(f) for f in run["got"]["replay_tower"]]
    want = ref["core"].bank_hash_of
    votes = tcluster.check_votes(run["votes"],
                                 tcluster.Cluster.follower_identity(),
                                 {s: want[s] for s, *_ in blocks})
    assert 1 <= len(votes) == fm["send"]["sent"] <= fm["tower"]["votes_out"]
    assert fm["send"]["sign_fail"] == 0 and fm["sign"]["refused"] == 0


def test_follower_snapshot_restores_to_the_references_store(run, ref):
    """The replay's snapshot (every 64 slots) restores through the JAX
    package's snapshot_restore_into into a fresh store equal to the
    reference oracle's at that slot, under that slot's bank hash."""
    from firedancer_tpu.funk.funk import Funk
    from firedancer_tpu.utils.checkpt import snapshot_restore_into
    funk = Funk()
    slot, bank_hash, cnt = snapshot_restore_into(funk,
                                                 io.BytesIO(run["snap"]))
    assert slot == run["snap_slot"] and slot > 0 and slot % 64 == 0
    assert bank_hash == ref["core"].bank_hash_of[slot]
    assert funk.root_items() == ref["store"]
    assert cnt == len(ref["store"])


def test_follower_leader_is_devs(run):
    """The leader the harness boots is app.dev's: cfg/leader.toml with
    the genesis in bank0 (its overlay), then cfg/cluster.toml, dropping
    no slot."""
    tiles = {t["name"]: t for t in run["leader_cfg"]["tile"]}
    assert tiles["bank0"]["genesis_ckpt"] == os.path.abspath(run["ckpt"])
    assert tiles["bank0"]["genesis_synth"] == 768
    assert tiles["shred"]["drop_slot_every"] == 0
    assert run["got"]["metrics"]["leader"]["shred"]["dropped"] == 0
