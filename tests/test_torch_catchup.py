"""bench.py's catch-up stage on the port (firedancer_tpu_torch/tools/
catchup.py) on the CPU, and the cold-start drills: the follower topology
at bench.py's defaults (snapld -> snapin into the shm store, playback ->
replay behind its restore gate over two exec shards) lands on the bank
hashes of the JAX package's ReplayCore oracle over the same slices, and
on its accounts; cfg/catchup.toml is that topology and boots with
`app.run`; a corrupt frame and a stale offer are refused with the store
untouched; a crash halfway through snapld's stream is restarted and
restored; a crash inside the replay's snapshot writer leaves the previous
file intact; the bank boots from a genesis_ckpt as from its dict. Every
comparison is exact. This is the one new file of the slice that boots
processes.

The reference's modules load its native library when imported, so they
are imported inside fixtures, not at collection."""
import os
import subprocess
import sys

import pytest

from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.runtime import Workspace
from firedancer_tpu_torch.tools import catchup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "catchup.toml")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """bench.py's fixture at its defaults (the port's oracle on the CPU),
    a stale snapshot (slot 2) beside it, and the reference's ReplayCore
    over InlineFanout replaying the same slices."""
    from firedancer_tpu.disco.tiles import _synth_genesis
    from firedancer_tpu.funk.funk import Funk
    from firedancer_tpu.tiles.replay import InlineFanout, ReplayCore
    tmp = str(tmp_path_factory.mktemp("catchup"))
    fx = catchup.catchup_fixture(tmp)
    stale = catchup.stale_snapshot(fx, os.path.join(tmp, "stale.ckpt"), 2)
    funk = Funk()
    jcore = ReplayCore(genesis=_synth_genesis(catchup.UNIQUE),
                       verify_poh=False, funk=funk,
                       fanout=InlineFanout(funk))
    slices = catchup.fixture_slices(catchup.COUNT, catchup.SLOTS)
    for s in range(1, catchup.SLOTS + 1):
        jcore.on_slice(slices[s])
    return {**fx, "tmp": tmp, "stale": stale, "ref": jcore}


def test_the_oracle_is_the_references(fixture):
    """The port's CPU oracle gives the reference's bank hash in every
    slot and its balances."""
    jcore = fixture["ref"]
    assert fixture["bank_hashes"] == {
        str(s): h.hex() for s, h in jcore.bank_hash_of.items() if s > 0}
    assert fixture["expected"] == {
        str(s): jcore.bank_hash_of[s].hex()
        for s in range(catchup.SNAP_SLOT + 1, catchup.SLOTS + 1)}
    assert {k: v.lamports for k, v in fixture["accounts"].items()} \
        == {k: v.lamports for k, v in jcore.funk.root_items().items()}
    assert fixture["txns"] == jcore.metrics["txns"] == catchup.COUNT


def test_catchup_stage_on_the_cpu_lands_on_the_references_hashes(fixture):
    """The follower topology (seven processes, replay and exec on the
    CPU): restore slot 4, no divergent slot, every replayed slot's bank
    hash (its tower frames) the reference oracle's, every store account
    the oracle's (run_catchup asserts them), and bench.py's keys."""
    rec = catchup.run_catchup(device="cpu", fixture=fixture)
    assert rec["catchup_slots"] == catchup.SLOTS - catchup.SNAP_SLOT
    assert rec["catchup_count"] == catchup.COUNT
    assert rec["catchup_restore_slot"] == catchup.SNAP_SLOT
    assert rec["catchup_divergent_slot"] == 0
    assert rec["bank_hashes"] == rec["catchup_slots"] \
        and rec["catchup_exec_waves"] >= rec["catchup_slots"]
    assert rec["catchup_s"] > 0 and rec["replay_tps"] > 0
    assert sum(rec["exec_txns"].values()) == rec["txns"] > 0
    assert rec["gate_s"] >= rec["gate_fold_s"] > 0


def test_catchup_toml_is_the_stage_and_pins_the_fixtures_hashes(fixture):
    """cfg/catchup.toml declares the follower topology of
    tools/catchup.py (the same links, kinds, wiring and args, paths
    aside) and pins the fixture's tail bank hashes."""
    got = tconfig.build_topology(tconfig.load_config(TOML))
    want = catchup.follower_topology("S", "T", fixture["expected"],
                                     catchup.SNAP_SLOT, catchup.EXEC_TILES)
    assert {n: (l.depth, l.mtu) for n, l in got.links.items()} \
        == {n: (l.depth, l.mtu) for n, l in want.links.items()}
    drop = {"path", "device"}
    assert {n: (t.kind, t.ins, t.outs,
                {k: v for k, v in t.args.items() if k not in drop})
            for n, t in got.tiles.items()} \
        == {n: (t.kind, t.ins, t.outs,
                {k: v for k, v in t.args.items() if k not in drop})
            for n, t in want.tiles.items()}
    assert got.tiles["replay"].args["expected"] == fixture["expected"]
    assert got.snapshot["min_slot"] == want.snapshot["min_slot"]


def test_app_run_boots_catchup_toml_on_the_cpu(fixture, tmp_path):
    """`app.run` on cfg/catchup.toml with a layer pointing it at the
    fixture, --device cpu: the replay restores at slot 4 and replays
    the tail with no divergent slot, and the command exits 0."""
    layer = tmp_path / "paths.toml"
    layer.write_text(
        f'[snapshot]\npath = "{fixture["snap"]}"\n\n'
        f'[[tile]]\nname = "playback"\npath = "{fixture["tail"]}"\n')
    r = subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run", TOML,
         str(layer), "--device", "cpu", "--duration", "30", "--interval",
         "1", "--name", f"tcu{os.getpid()}"], cwd=ROOT, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("replay ")]
    assert rows and "slots_replayed=8" in rows[-1] \
        and "restore_slot=4" in rows[-1] \
        and "divergent_slot" not in rows[-1], r.stdout[-3000:]


@pytest.fixture()
def wksp():
    w = Workspace(f"/fdtt_cud_{os.getpid()}", 1 << 25)
    yield w
    w.close()
    w.unlink()


def test_corrupt_frame_and_stale_offer_leave_the_store_untouched(fixture,
                                                                 wksp):
    d = catchup.snapshot_drills(wksp, fixture["snap"], fixture["stale"],
                                catchup.SNAP_SLOT)
    assert d["corrupt_checkpt_frame"]["restored"] == 0
    assert d["stale_snapshot_offer"]["error"] \
        == "stale snapshot: slot 2 < required 4"
    assert d["clean"] == {"accounts": _snapshot_records(fixture),
                          "slot": catchup.SNAP_SLOT}


def _snapshot_records(fixture) -> int:
    from firedancer_tpu_torch.funk.funk import Funk
    from firedancer_tpu_torch.utils.checkpt import snapshot_restore_into
    with open(fixture["snap"], "rb") as fp:
        return snapshot_restore_into(Funk(), fp)[2]


def test_snapld_crash_is_restarted_and_the_restore_completes(fixture):
    d = catchup.snapld_crash_drill(fixture["snap"], catchup.SNAP_SLOT,
                                   name=f"tcuk{os.getpid()}")
    assert d["restarts"] == 1 and d["snapin_frags"] > d["loader_frags"]


def test_snapshot_writer_crash_keeps_the_previous_file(fixture, tmp_path):
    d = catchup.writer_crash_drill(fixture["snap"], fixture["tail"],
                                   fixture["expected"], catchup.SNAP_SLOT,
                                   str(tmp_path), device="cpu")
    assert d["exitcode"] == 72 and d["intact_slot"] == 6
    assert d["tmp_refused"]


def test_bank_boots_from_a_genesis_ckpt_as_from_its_dict(wksp, tmp_path):
    """tools/exec_drills.genesis_ckpt_boot on the CPU; the checkpoint the
    reference writes of the same genesis is byte-equal to it."""
    from firedancer_tpu.funk.funk import Funk as JFunk
    from firedancer_tpu.utils.checkpt import funk_checkpt as jcheckpt
    from firedancer_tpu_torch.tiles.synth import make_signed_txns
    from firedancer_tpu_torch.tools import exec_drills
    path = str(tmp_path / "g.ckpt")
    d = exec_drills.genesis_ckpt_boot(wksp, make_signed_txns(18, seed=47),
                                      path, device="cpu")
    assert d["transfers"] == 18 and d["poh_frames"] >= 1
    jf = JFunk()
    for k, bal in exec_drills.synth_genesis().items():
        jf.rec_write(None, bytes.fromhex(k), int(bal))
    import io
    buf = io.BytesIO()
    jcheckpt(jf, buf)
    assert buf.getvalue() == open(path, "rb").read()
