"""The port's general bank (firedancer_tpu_torch/disco/tiles.py BankAdapter
with exec="general") against the JAX package's, in process over each
package's own rings from one genesis checkpoint (tools/general_exec.py at
a small size): mixed microblocks (votes, TowerSync, transfers, stake,
lookup-table and precompile txns, v0 transfers through the tables, the
designed failures) crossing epoch boundaries, so the boundary's stake
history and partitioned rewards run; every poh and completion frame, the
metrics and every account of the store must be equal (exact). Then
cfg/general.toml as eleven processes on the CPU at a small size
(general_exec.run_general: the sock door reads every datagram, every txn
is executed, failed or a counted drop, the failures are the designed
ones, rewards are paid, and bank0's store equals the plain general path
over the microblocks it took), `app.run` on the file, and the boot
without its checkpoint."""
import os
import struct
import subprocess
import sys

import pytest

from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu.utils import checkpt as jcheckpt
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.tools import general_exec as gx
from test_torch_leader import PKGS, ROOT, Rig

GENERAL_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg",
                            "general.toml")
LINKS = dict(ins={"mb": (256, 16384)},
             outs={"done": (256, 64), "poh": (256, 16448)})
SPE = 4


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    wl = gx.build(8, 8, tables=2, table_addrs=8, scale=0.1)
    path = str(tmp_path_factory.mktemp("gx") / "genesis.ckpt")
    return wl, gx.write_genesis(wl, path)


@pytest.fixture(scope="module")
def wksps():
    from firedancer_tpu import runtime as jrt
    from firedancer_tpu_torch import runtime as trt
    ws = (jrt.Workspace(f"/fdtpu_tgb_{os.getpid()}", 1 << 25),
          trt.Workspace(f"/fdtt_tgb_{os.getpid()}", 1 << 25))
    yield ws
    for w in ws:
        w.close()
        w.unlink()


def _microblocks(wl, per=7):
    """The workload (v0 included) as microblock frames, `per` txns each,
    at slots that cross epochs 0 -> 1 -> 3 (slots_per_epoch 4)."""
    txns = [p for _, p, _ in wl.traffic] + [p for _, p in wl.v0]
    frames = []
    for i in range(0, len(txns), per):
        grp = txns[i:i + per]
        slot = (0, 1, 5, 6, 13)[min(4, 5 * i // len(txns))]
        frames.append(struct.pack("<HHQQ", 0, len(grp), i // per, slot)
                      + b"".join(struct.pack("<H", len(t)) + t
                                 for t in grp))
    return frames


def _root(funk, acct_cls):
    return {bytes(k): (v.lamports, bytes(v.data), v.owner, v.executable)
            for k, v in funk.root_items().items()
            if isinstance(v, acct_cls)}


def test_general_bank_matches_reference(wksps, small):
    from firedancer_tpu.svm import accdb as jaccdb
    from firedancer_tpu_torch.svm import accdb as taccdb
    wl, genesis = small
    args = {"exec": "general", "poh_link": "poh", "wave": 2,
            "forward_payloads": True, "genesis_ckpt": genesis,
            "slots_per_epoch": SPE}
    rigs = [Rig(rt, tiles, w, "bank", {**args, **extra}, **LINKS,
                fseq=("done", "poh"))
            for (rt, tiles), w, extra in zip(PKGS, wksps,
                                             ({}, {"device": "cpu"}))]
    frames = _microblocks(wl)
    for r in rigs:
        for i, f in enumerate(frames):
            r.publish("mb", f, i)
    got = []
    for r in rigs:
        while r.tile.poll_once():
            pass
        got.append((r.drain("poh"), r.drain("done")))
    assert got[1] == got[0]
    assert len(got[1][1]) == len(frames)
    mj, mt = rigs[0].tile.m, rigs[1].tile.m
    common = ("microblocks", "txns", "transfers", "exec_skip", "exec_fail",
              "overruns", "rewards_paid")
    assert {k: mt[k] for k in common} == {k: mj[k] for k in common}
    assert mt["exec_fail"] == wl.designed_fail
    assert mt["rewards_paid"] > 0 and mt["wave_launches"] == 0
    assert _root(rigs[1].tile.funk, taccdb.Account) == \
        _root(rigs[0].tile.funk, jaccdb.Account)
    # the paid-through marker persisted the last boundary crossed
    from firedancer_tpu_torch.flamenco import rewards
    assert rewards.paid_through(rigs[1].tile.funk, None) == 13 // SPE


def test_genesis_checkpoint_reads_in_both_packages(small):
    _, genesis = small
    funks = []
    for mod, fk in ((jcheckpt, jfunk), (None, tfunk)):
        from firedancer_tpu_torch.utils import checkpt as tcheckpt
        with open(genesis, "rb") as f:
            funks.append((mod or tcheckpt).funk_restore(fk.Funk, f))
    assert {k: (v.lamports, bytes(v.data), v.owner)
            for k, v in funks[0].root_items().items()} == \
        {k: (v.lamports, bytes(v.data), v.owner)
         for k, v in funks[1].root_items().items()}


def test_general_bank_without_its_checkpoint_raises(wksps):
    from firedancer_tpu_torch import runtime as trt
    from firedancer_tpu_torch.disco import tiles as ttiles
    with pytest.raises(FileNotFoundError, match="nosuch.ckpt"):
        Rig(trt, ttiles, wksps[1], "bank",
            {"exec": "general", "device": "cpu", "poh_link": "poh",
             "genesis_ckpt": "nosuch.ckpt"}, **LINKS)
    with pytest.raises(ValueError, match="exec_links need"):
        Rig(trt, ttiles, wksps[1], "bank",
            {"exec": "general", "device": "cpu", "exec_links": ["x"],
             "exec_done": ["y"]}, ins={"mb": (16, 16384), "y": (16, 64)},
            outs={"done": (16, 64), "x": (16, 4096)})


def test_general_toml_drains_on_the_cpu(small, tmp_path):
    """chip_smoke.py 23a at a small size with verify and bank0 on the
    CPU."""
    wl, genesis = small
    rec = gx.run_general(GENERAL_TOML, wl, genesis, "cpu",
                         f"tgt{os.getpid()}", str(tmp_path / "final.ckpt"),
                         timeout_s=120)
    assert rec["exec_fail"] == wl.designed_fail
    assert rec["sent"] == rec["door_rx"] == len(wl.traffic)
    assert rec["rewards_paid"] > 0 and rec["epochs"] >= 1


def test_app_run_boots_general_toml_on_the_cpu(small, tmp_path):
    """From a directory holding the checkpoint where the TOML names it
    (paths are relative to the working directory)."""
    _, genesis = small
    dst = tmp_path / "firedancer_tpu_torch" / "build" / "general"
    dst.mkdir(parents=True)
    os.link(genesis, dst / "genesis.ckpt")
    r = subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run",
         GENERAL_TOML, "--device", "cpu", "--duration", "2",
         "--interval", "60"], cwd=tmp_path, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for tn in ("sock", "verify0", "verify1", "dedup", "pack", "bank0",
               "poh", "shred", "sign", "shredsink"):
        assert f"\n{tn} " in r.stdout, tn
