"""The port's exec tile family, resolv tile and shm-store topology
(firedancer_tpu_torch/disco/tiles.py ExecFanout, ExecAdapter,
ResolvAdapter, BankAdapter's `exec_links`, PackAdapter's `resolved_in`;
disco/topo.py's store carve and per-shard in links; cfg/exec.toml)
against the JAX package's (tests/test_exec_tile.py's harness), on the
CPU's plain versions:

* the conflict-group partition, group for group;
* the fan-out's poh frames, done frags and balances equal to the
  reference's fan-out and to the in-process svm bank, frame for frame;
* no account in two shards' dispatch frames, the wire equal to the
  reference's;
* the death redispatch drill: a cancelled fork's frames abandoned
  (stale_xid), balances exactly once, the same frames out as the
  reference's bank;
* RESOLVED frames byte-identical to the reference's ResolvAdapter:
  legacy txns, junk, the fee-payer gate, v0 txns whose lookup table is
  an AlutState written into both stores (resolved, missing, foreign,
  out of range);
* the family topology and cfg/exec.toml built alike by both packages,
  the store carved into the plan; the loop as spawned processes with a
  supervised exec crash; `app.run` on cfg/exec.toml.
Exact: frames are bytes, balances integers."""
import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest

from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.runtime import Store as JStore
from firedancer_tpu.runtime import Workspace as JWorkspace
from firedancer_tpu.svm import alut as jalut
from firedancer_tpu.svm.accdb import Account as JAccount
from firedancer_tpu.svm.executor import SystemTxn as JSystemTxn
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.protocol.txn import build_message, build_txn
from firedancer_tpu_torch.runtime import Ring, Store
from firedancer_tpu_torch.runtime import Workspace as TWorkspace
from firedancer_tpu_torch.svm import alut as talut
from firedancer_tpu_torch.svm.accdb import Account as TAccount
from firedancer_tpu_torch.svm.executor import SystemTxn
from firedancer_tpu_torch.tiles.synth import make_signed_txns
from firedancer_tpu_torch.disco.tiles import \
    _synth_genesis as _tsynth_genesis
from firedancer_tpu_torch.pack.scheduler import FEE_PER_SIGNATURE
from firedancer_tpu_torch.tools import exec_drills, exec_scale, leader_drain
from test_exec_tile import (_drain, _family_topology, _microblocks,
                            _mk_family, _mk_resolv, _synth_genesis)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXEC_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg", "exec.toml")
REF_EXEC_TOML = os.path.join(ROOT, "cfg", "exec-demo.toml")


@pytest.fixture
def wksps():
    """(the reference's workspace, the port's), 16 MiB each."""
    j = JWorkspace(f"/fdtpu_tex{os.getpid()}", 1 << 24)
    t = TWorkspace(f"/fdtt_tex{os.getpid()}", 1 << 24)
    yield j, t
    for w in (j, t):
        w.close()
        w.unlink()


@pytest.fixture(scope="module")
def txns():
    return make_signed_txns(18, seed=77)


# -- conflict groups ----------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_conflict_groups_match_reference(seed):
    """Random transfers over few accounts (long chains): the same
    groups, each in original order, pairwise account-disjoint."""
    rng = random.Random(seed)
    keys = [bytes([i]) * 32 for i in range(12)]
    spec = [(rng.choice(keys), rng.choice(keys), rng.randrange(100), i)
            for i in range(60)]
    got = ttiles._conflict_groups([SystemTxn(*s) for s in spec])
    want = jtiles._conflict_groups([JSystemTxn(*s) for s in spec])
    assert [[t.fee for t in g] for g in got] == \
        [[t.fee for t in g] for g in want]
    accts = [{k for t in g for k in (t.src, t.dst)} for g in got]
    for i in range(len(accts)):
        for j in range(i + 1, len(accts)):
            assert not accts[i] & accts[j]


# -- the fan-out in process ---------------------------------------------

def _ref_fanout(jw, frames, genesis):
    """The reference's bank over two reference exec tiles."""
    bank, execs, rings = _mk_family(jw, n_exec=2, genesis=genesis)
    for i, f in enumerate(frames):
        rings["pack_bank0"].publish(f, sig=i)
    bank.poll_once()
    for e in execs:
        e.poll_once()
    bank.poll_once()
    assert bank.fanout.wave is None
    return bank, _drain(rings["bank0_poh"])[0], _drain(
        rings["bank0_done"])[0]


def test_fanout_byte_identity_matches_reference(wksps, txns):
    """The same microblock frames through the port's fan-out over two
    exec tiles, the port's in-process bank (exec_drills.byte_identity
    holds these two equal) and the reference's fan-out: every poh frame,
    done frag and touched balance equal, and both shards carried work."""
    jw, tw = wksps
    got = exec_drills.byte_identity(tw, txns, device="cpu")
    frames = exec_drills.microblocks(txns)
    assert frames == _microblocks(txns)
    genesis = _synth_genesis()
    assert genesis == exec_drills.synth_genesis()
    jbank, jpoh, jdone = _ref_fanout(jw, frames, genesis)
    assert got["poh"] == jpoh and len(jpoh) == 3
    assert got["done"] == jdone
    assert got["balances"] == {k: jbank.funk.rec_query(
        None, bytes.fromhex(k)) for k in genesis}
    assert got["transfers"] == jbank.m["transfers"] == len(txns)
    assert min(got["shard_txns"]) > 0


def test_cross_tile_isolation_matches_reference(wksps):
    """The conflict chain and the disjoint pairs on the wire: the port's
    dispatch frames are the reference's, byte for byte, no account in
    two shards, the chain on one shard in order, balances == serial."""
    jw, tw = wksps
    got = exec_drills.conflict_isolation(tw, device="cpu")
    import hashlib
    keys = [hashlib.sha256(b"ct%d" % i).digest() for i in range(9)]
    bank, execs, rings = _mk_family(
        jw, n_exec=2, genesis={k.hex(): 1_000_000 for k in keys})
    jt = [JSystemTxn(keys[0], keys[1], 900_000, 0),
          JSystemTxn(keys[1], keys[2], 1_800_000, 0),
          JSystemTxn(keys[2], keys[3], 2_000_000, 0),
          JSystemTxn(keys[4], keys[5], 5, 7),
          JSystemTxn(keys[6], keys[7], 11, 0),
          JSystemTxn(keys[8], keys[8], 13, 0)]
    bank.fanout.dispatch(jt, tag=[])
    want = [_drain(rings[f"exec_disp{i}"])[0] for i in range(2)]
    assert got["wire"] == want
    for e in execs:
        e.poll_once()
    bank.poll_once()
    assert got["balances"] == {k.hex(): bank.funk.rec_query(None, k)
                               for k in keys}


def test_shard_death_redispatch_matches_reference(wksps):
    """A shard dead at dispatch: no publish on a partial completion
    set, cancel + redispatch under a fresh fork on the deadline, the
    restarted shards abandon the cancelled fork's frames, balances
    exactly once; the poh and done frames are the reference's
    in-process bank's for the same microblocks."""
    jw, tw = wksps
    txns = make_signed_txns(12, seed=91)
    got = exec_drills.shard_death(tw, txns, device="cpu")
    assert got["exec_redispatch"] == 1 and got["stale_xid"] >= 1
    jbank, jpoh, jdone = _ref_fanout(jw, _microblocks(txns),
                                     _synth_genesis())
    assert got["poh"] == jpoh and got["done"] == jdone
    assert len(got["balances"]) > len(_synth_genesis())  # dsts too
    assert got["balances"] == {k: jbank.funk.rec_query(
        None, bytes.fromhex(k)) for k in got["balances"]}


def test_exec_and_bank_refusals(wksps):
    """An exec tile without a shm store, a bank whose exec_links do not
    pair up or run without exec="svm": the reference's ValueErrors. The
    bank's genesis_ckpt is refused with exec links only, as the
    reference's (its ValueError); without them the bank boots from the
    checkpoint (tools/exec_drills.genesis_ckpt_boot)."""
    from types import SimpleNamespace
    _, tw = wksps
    ring = Ring.create(tw, depth=16, mtu=4096)
    out = Ring.create(tw, depth=16, mtu=64)
    links = {"d": {"mtu": 4096}, "o": {"mtu": 64}, "x": {"mtu": 64}}
    ctx = SimpleNamespace(tile_name="e", plan={"links": links}, wksp=tw,
                          in_rings={"d": ring}, out_rings={"o": out},
                          out_fseqs={"o": []}, in_seq0={})
    with pytest.raises(ValueError, match="needs \\[funk\\] backend"):
        ttiles.ExecAdapter(ctx, {"device": "cpu"})
    bctx = SimpleNamespace(tile_name="b", plan={"links": links}, wksp=tw,
                           in_rings={"d": ring},
                           out_rings={"o": out, "x": out},
                           out_fseqs={"o": [], "x": []}, in_seq0={})
    with pytest.raises(ValueError, match="must pair up"):
        ttiles.BankAdapter(bctx, {"exec": "svm", "exec_links": ["x"],
                                  "device": "cpu"})
    with pytest.raises(ValueError, match="need \\[funk\\] backend"):
        ttiles.BankAdapter(bctx, {"exec": "svm", "exec_links": ["x"],
                                  "exec_done": ["y"], "device": "cpu"})
    with pytest.raises(ValueError, match="need exec=\"svm\""):
        ttiles.BankAdapter(bctx, {"exec": "stub", "exec_links": ["x"],
                                  "exec_done": ["y"]})
    with pytest.raises(ValueError, match="genesis_ckpt is process-funk "
                                         "only"):
        ttiles.BankAdapter(bctx, {"exec": "svm", "genesis_ckpt": "g.bin",
                                  "exec_links": ["x"], "exec_done": ["y"],
                                  "device": "cpu"})


def test_exec_adapter_on_the_card_without_one_fails_its_boot(wksps):
    """device="cuda" (the default) without a card: the boot wave raises;
    the tile never runs on the CPU in its place."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    _, tw = wksps
    bank, execs, rings = exec_drills.family(tw, n_exec=1, device="cpu")
    plan = execs[0].ctx.plan
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttiles.ExecAdapter(exec_drills.exec_ctx(tw, plan, rings, 0), {})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttiles.ExecAdapter(exec_drills.exec_ctx(tw, plan, rings, 0),
                           {"device": "cuda"})


# -- resolv -------------------------------------------------------------

def _port_resolv(tw, funk_plan=None, **args):
    from types import SimpleNamespace
    links = {"dr": {"mtu": 1280}, "rp": {"mtu": 2048}}
    rings = {ln: Ring.create(tw, depth=64, mtu=li["mtu"])
             for ln, li in links.items()}
    plan = {"links": links}
    if funk_plan:
        plan["funk"] = funk_plan
    ctx = SimpleNamespace(
        tile_name="resolv", plan=plan, wksp=tw,
        in_rings={"dr": rings["dr"]}, out_rings={"rp": rings["rp"]},
        out_fseqs={"rp": []}, in_seq0={})
    return ttiles.ResolvAdapter(ctx, args), rings


def _funk_plan(store):
    return {"backend": "shm", "rec_max": 512, "txn_max": 16,
            "heap_mb": 1, "off": store.off, "heap_sz": 1 << 18}


def _v0(payer, table, w_idxs, ro_idxs, seed):
    """A v0 transfer from `payer` whose destination loads from `table`
    (signature bytes are not checked by the resolv tile)."""
    sysid = bytes(32)
    msg = build_message([payer], [sysid], bytes([seed]) * 32,
                        [(1, bytes([0, 2]), b"\x02\x00\x00\x00"
                          + (5).to_bytes(8, "little"))],
                        n_ro_unsigned=1, version=0,
                        aluts=[(table, bytes(w_idxs), bytes(ro_idxs))])
    return build_txn([bytes([seed]) * 64], msg)


def _resolv_inputs():
    """Legacy txns, junk, and v0 txns against a good, a foreign and a
    missing table, with an out-of-range index; the table accounts to
    write into the store."""
    legacy = make_signed_txns(6, seed=29)
    payer = b"\x51" * 32
    good, foreign, missing = b"\x61" * 32, b"\x62" * 32, b"\x63" * 32
    addrs = [bytes([0x70 + i]) * 32 for i in range(3)]
    inputs = legacy + [b"\x00junk", b"\xff" * 3,
                       _v0(payer, good, [0], [1], 1),
                       _v0(payer, good, [2], [], 2),
                       _v0(payer, good, [3], [], 3),      # out of range
                       _v0(payer, foreign, [0], [], 4),
                       _v0(payer, missing, [0], [], 5)]
    return legacy, inputs, payer, good, foreign, addrs


@pytest.mark.parametrize("store", [False, True])
def test_resolv_frames_match_reference(wksps, store):
    """The same frames through both ResolvAdapters, with and without the
    shm store: RESOLVED frames byte for byte (sigs too) and every
    metric. With the store the fee-payer gate is on (half the legacy
    payers funded) and v0 tables resolve from an AlutState written into
    both stores; without it every v0 lookup is an alut_fail."""
    jw, tw = wksps
    legacy, inputs, payer, good, foreign, addrs = _resolv_inputs()
    tiles = []
    for pkg, w, store_cls, acct, alut, mk in (
            ("ref", jw, JStore, JAccount, jalut, _mk_resolv),
            ("port", tw, Store, TAccount, talut, _port_resolv)):
        fp = None
        if store:
            st = store_cls(w, rec_max=512, txn_max=16, heap_sz=1 << 18)
            fp = _funk_plan(st)
        tile, rings = mk(w, funk_plan=fp)
        if store:
            db = tile.db.funk
            from firedancer_tpu_torch.protocol.txn import parse_txn
            for p in legacy[:3] + [None]:
                key = payer if p is None else \
                    parse_txn(p).account_keys(p)[0]
                db.rec_write(None, key, acct(lamports=5000 * 4))
            state = alut.AlutState(b"\x09" * 32, addresses=addrs)
            db.rec_write(None, good, acct(
                lamports=1, data=state.to_bytes(),
                owner=alut.ALUT_PROGRAM_ID))
            db.rec_write(None, foreign, acct(lamports=1,
                                             data=state.to_bytes()))
        for i, p in enumerate(inputs):
            rings["dr"].publish(p, sig=100 + i)
        tile.poll_once()
        tiles.append((tile, _drain(rings["rp"])[0]))
    (jt, jframes), (tt, tframes) = tiles
    assert tframes == jframes
    assert tt.m == jt.m
    assert tt.m["rx"] == len(inputs) and tt.m["parse_fail"] == 2
    if store:
        assert tt.m["fee_fail"] == 3 and tt.m["alut_fail"] == 3
        assert tt.m["resolved"] == 5
    else:
        assert tt.m["alut_fail"] == 5 and tt.m["resolved"] == 6
    assert len(tframes) == tt.m["resolved"]


def test_pack_takes_resolved_frames(wksps):
    """pack with resolved_in=true schedules from RESOLVED frames what it
    schedules from the raw payloads (meta_from_resolved vs
    meta_from_payload), as the reference's pack does."""
    _, tw = wksps
    from firedancer_tpu_torch.pack.scheduler import (meta_from_payload,
                                                     meta_from_resolved)
    tile, rings = _port_resolv(tw)
    legacy = make_signed_txns(8, seed=13)
    for i, p in enumerate(legacy):
        rings["dr"].publish(p, sig=i)
    tile.poll_once()
    for (frame, _), p in zip(_drain(rings["rp"])[0], legacy):
        got, want = meta_from_resolved(frame), meta_from_payload(p)
        assert (got.payload, got.writes, got.reads, got.cost, got.reward,
                got.is_vote) == (want.payload, want.writes, want.reads,
                                 want.cost, want.reward, want.is_vote)


# -- topology -----------------------------------------------------------

def _port_family_topology(name, n=24, exec_cnt=2, chaos0=None,
                          redispatch_s=1.0):
    """tests/test_exec_tile.py's _family_topology on the port's
    Topology, verify, bank and exec tiles on the CPU."""
    topo, genesis = _family_topology(name, n, exec_cnt, chaos0,
                                     redispatch_s)
    t = Topology(name, wksp_size=topo.wksp_size, funk=topo.funk)
    for ln in topo.links.values():
        t.link(ln.name, depth=ln.depth, mtu=ln.mtu)
    for tc, depth in topo.tcaches.items():
        t.tcache(tc, depth=depth)
    for tn, spec in topo.tiles.items():
        args = dict(spec.args)
        if spec.kind in ("verify", "bank", "exec"):
            args["device"] = "cpu"
        t.tile(tn, spec.kind, ins=[(i["link"], i["reliable"])
                                   for i in spec.ins],
               outs=spec.outs, **args)
    return t, topo, genesis


def _specs(topo):
    return {tn: (t.kind, t.ins, t.outs,
                 {k: v for k, v in t.args.items() if k != "device"})
            for tn, t in topo.tiles.items()}


def test_family_topology_builds_like_reference():
    """The reference's sharded exec family built through the port's
    sharded_tile gives the same tiles (one dispatch ring each), and the
    port's build carves the store into the plan as the reference's
    does; cfg/exec.toml is cfg/exec-demo.toml less its metric tile
    under both loaders."""
    name = f"tfb{os.getpid()}"
    port, ref, _ = _port_family_topology(name)
    t = Topology(name, funk=ref.funk)
    t.sharded_tile("exec", "exec", 2, ins=[["exec_disp0", "exec_disp1"]],
                   outs=["exec_done0", "exec_done1"], batch=8)
    for i in range(2):
        assert [x["link"] for x in t.tiles[f"exec{i}"].ins] == \
            [f"exec_disp{i}"]
        assert t.tiles[f"exec{i}"].args == {"batch": 8, "rr_cnt": 2,
                                            "rr_idx": i}
    with pytest.raises(ValueError, match="one link per shard"):
        t.sharded_tile("x", "exec", 2, ins=[["a", "b", "c"]],
                       outs=["p", "q"])
    assert _specs(port) == _specs(ref)
    plan = port.build()
    try:
        fk = plan["funk"]
        assert fk["backend"] == "shm" and fk["off"] > 0
        assert fk["heap_sz"] == 4 << 20
        assert {k: fk[k] for k in ("rec_max", "txn_max", "heap_mb")} == \
            {"rec_max": 4096, "txn_max": 256, "heap_mb": 4}
        w = TWorkspace(plan["wksp"]["name"], plan["wksp"]["size"],
                       create=False)
        st = Store(w, off=fk["off"], rec_max=fk["rec_max"],
                   txn_max=fk["txn_max"], heap_sz=fk["heap_sz"])
        assert st.rec_cnt() == 0 and st.txn_exists(0) is False
        w.close()
    finally:
        TWorkspace.unlink_name(plan["wksp"]["name"])
    got = tconfig.build_topology(tconfig.load_config(EXEC_TOML))
    want = jconfig.build_topology(jconfig.load_config(REF_EXEC_TOML))
    assert "metric" in want.tiles
    del want.tiles["metric"]
    assert _specs(got) == _specs(want)
    assert got.funk == want.funk


def _wait_transfers(runner, n, timeout_s=120.0):
    import time
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        b = runner.metrics("bank0")
        if b["transfers"] >= n and runner.metrics("poh")["mixins"] \
                == b["microblocks"] > 0:
            return b
        assert time.monotonic() < deadline, f"never drained: {b}"
        time.sleep(0.05)


def test_family_loop_with_a_supervised_exec_crash_on_the_cpu():
    """The reference's kill drill as spawned processes on the port:
    resolv ahead of pack, two exec shards, exec0 crashes after its first
    frames and the restart policy respawns it. Every funded transfer
    applies exactly once, the loop drains, and every tile exits 0."""
    n = 24
    topo, _, genesis = _port_family_topology(
        f"tfk{os.getpid()}", n=n, exec_cnt=2,
        chaos0=[{"seed": 1, "events": [{"action": "crash", "at_rx": 1}]},
                None])
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=120)
        b = _wait_transfers(runner, n)
        assert b["transfers"] == n and b["exec_fail"] == 0
        assert leader_drain.wait_restarted(runner, "exec0", 120) >= 1
        assert runner.metrics("resolv")["resolved"] == n
        assert runner.metrics("pack")["inserted"] == n
        runner.halt()
        # exactly once: genesis less one signature fee a transfer (a
        # respawned shard's own counters start again from 0)
        assert exec_scale.store_lamports(runner) == \
            sum(genesis.values()) - FEE_PER_SIGNATURE * n
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, (tn, p.exitcode)
    finally:
        runner.halt()
        runner.close()


def test_exec_toml_drains_with_a_supervised_kill_on_the_cpu():
    """cfg/exec.toml (two exec shards, resolv, the shred leg) through the
    config loader and the runner app.run uses, on the CPU at 96 frames:
    exec0 crashes at its first frames and restarts; bench.py's
    conservation rule with the resolv tile's drops holds, pack retires
    every microblock, the shards' transfers sum to the bank's, the
    store's lamports are genesis less the fees burned, and every tile
    exits 0 after the halt."""
    cfg = tconfig.load_config(EXEC_TOML, overrides={"tile": [
        {"name": "synth", "count": 96, "unique": 96},
        {"name": "verify", "device": "cpu"},
        {"name": "bank0", "device": "cpu", "redispatch_s": 1.0},
        {"name": "exec", "device": "cpu",
         "chaos": [{"seed": 1, "events": [{"action": "crash",
                                            "at_rx": 1}]}, None],
         "supervise": {"policy": "restart", "backoff_s": 0.05,
                       "max_restarts": 3, "window_s": 60.0}}]})
    runner = TopologyRunner(tconfig.build_topology(
        cfg, name=f"tet{os.getpid()}").build()).start()
    try:
        runner.wait_running(timeout_s=120)
        runner.wait_idle("synth", "tx", 96, timeout_s=120)
        dropped = leader_drain.wait_drained(runner, 96, timeout_s=120)
        leader_drain.wait_restarted(runner, "exec0", timeout_s=120)
        m = leader_drain.drain_shred_leg(runner, timeout_s=120)
        b, p = m["bank0"], m["pack"]
        assert b["txns"] + dropped == 96 and dropped == 0
        assert p["completions"] == p["microblocks"]
        assert b["transfers"] == 96 and b["exec_fail"] == 0
        assert m["exec0"]["sup_restarts"] >= 1
        assert exec_scale.store_lamports(runner) == sum(
            _tsynth_genesis(64).values()) - FEE_PER_SIGNATURE * 96
        assert m["resolv"]["resolved"] == 96
        for tn, proc in runner.procs.items():
            assert proc.exitcode == 0, (tn, proc.exitcode)
    finally:
        runner.halt()
        runner.close()


def _run(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run", EXEC_TOML,
         *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=ROOT))


KILL_LAYER = """
[[tile]]
name = "exec"
supervise = { policy = "restart", backoff_s = 0.05, max_restarts = 3, window_s = 60.0 }
chaos = [ { seed = 1, events = [ { action = "crash", at_rx = 1 } ] },
          { seed = 2, events = [] } ]
"""


def test_app_run_exec_toml_with_a_supervised_kill_on_the_cpu(tmp_path):
    """`app.run` on cfg/exec.toml with a layer that crashes exec0 at its
    first frames under a restart policy, --device cpu: every tile boots
    and runs, the table shows exec0 restarted, and the command exits 0
    once stopped by SIGINT (its clean stop). The run lasts until exec0's
    row shows the restart, under a deadline of its own: on a loaded host
    the CPU verify tile may pass no frame for many seconds, so a fixed
    --duration can end the run before exec0 ever crashes (the drain
    after the restart is held by the test above)."""
    layer = tmp_path / "kill.toml"
    layer.write_text(KILL_LAYER)
    proc = subprocess.Popen(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run", EXEC_TOML,
         str(layer), "--device", "cpu", "--interval", "1",
         "--boot-timeout", "120", "--name", f"texk{os.getpid()}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    lines: list[str] = []
    restarted = threading.Event()

    def read():
        for ln in proc.stdout:
            lines.append(ln)
            if ln.startswith("exec0 ") and "sup_restarts=1" in ln:
                restarted.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + 240      # boot (120 s at most) + 120 s
    while not restarted.is_set() and proc.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    out, err = "".join(lines), proc.stderr.read()
    assert rc == 0, out[-2000:] + err[-2000:]
    for tn in ("synth", "verify", "dedup", "resolv", "pack", "bank0",
               "exec0", "exec1", "poh", "shred", "sign", "shredsink"):
        assert f"\n{tn} " in out, tn
    assert restarted.is_set(), out[-3000:]


def test_app_run_exec_toml_without_a_card_exits_1():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    r = _run("--duration", "2", "--boot-timeout", "120", "--interval",
             "60", "--name", f"texc{os.getpid()}")
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]


# -- bench.py's exec-scale stage ----------------------------------------

def test_exec_leader_topology_is_bench_less_core_pinning():
    """tools/exec_scale.py's loop at N = 1, 2, 4 builds bench.py's
    `_exec_leader_topology` (count 4096, unique 768, batch 32, two
    verify shards, unpaced), but for the verify shards' core pinning
    (which bench.py gives only a host with verify_tiles + N + 7 cores)
    and `device` on the verify, bank and exec tiles."""
    sys.path.insert(0, ROOT)
    import bench
    for n in (1, 2, 4):
        want = bench._exec_leader_topology(4096, 768, 32, 2, n, 0.0)
        got = exec_scale.exec_leader_topology(4096, 768, n)
        for t in want.tiles.values():
            t.args.pop("cpu_idx", None)
        assert _specs(got) == _specs(want)
        assert {ln: (s.depth, s.mtu) for ln, s in got.links.items()} == \
            {ln: (s.depth, s.mtu) for ln, s in want.links.items()}
        assert got.tcaches == want.tcaches and got.funk == want.funk
        assert all(t.args.get("device") == "cuda"
                   for t in got.tiles.values()
                   if t.kind in ("verify", "bank", "exec"))


def test_exec_scale_stage_on_the_cpu():
    """One boot of the stage at two shards on the CPU, at 96 frames: the
    run's counts exact (tools/exec_scale.run_exec_scale's checks: the
    conservation rule, pack's completions, the shards' txns against the
    bank's transfers, no stale fork or redispatch, the store's lamports
    genesis's less the fees, every account the serial executor's), both
    shards carrying frames."""
    r = exec_scale.run_exec_scale(2, count=96, unique=96, device="cpu")
    assert r["txns"] == 96 and r["transfers"] == 96
    assert min(r["exec_txns"].values()) > 0
    assert r["bank_exec_waves"] > 0 and r["bank_exec_redispatch"] == 0
    assert r["top_occupancy_tile"] in r["occupancy"]
