"""The port's follower path in process (firedancer_tpu_torch/tiles/shred.py
ShredRecoverCore, tiles/replay.py ReplayCore on the CPU's plain versions,
and their adapters) against the JAX package's: slots shredded by the
port's leader core are recovered (also from parity) into the same slices,
and replayed into the same per-slot bank hashes, PoH tips, tower frames
and metrics; out-of-order slots buffer, a tampered entry hash is a PoH
failure, and an `expected` mismatch raises, in both packages. The exec
fan-out (ReplayCore over ExecFanout and exec shards, the ReplayAdapter's
`exec_links`) gives the bank hashes and tower frames of the reference's
InlineFanout oracle, also across a dead shard's redispatch
(tests/test_follower.py). The reference runs at hashes_per_tick=8, as
tests/test_repair_replay.py:197 does. Exact: hashes and frames are
bytes."""
import hashlib
import os
import struct
from types import SimpleNamespace

import pytest

from firedancer_tpu.ops.poh import host_poh_append, host_poh_mixin
from firedancer_tpu.tiles import replay as jreplay
from firedancer_tpu.tiles import shred as jshred
from firedancer_tpu.tiles.synth import make_signed_txns, synth_signer_seed
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.shred import format as fmt
from firedancer_tpu_torch.shred.shred_dest import ClusterNode
from firedancer_tpu_torch.tiles import replay as treplay
from firedancer_tpu_torch.tiles import shred as tshred
from firedancer_tpu_torch.tiles.tower import pack_block, parse_block
from firedancer_tpu_torch.tools import exec_drills
from firedancer_tpu_torch.tools.slices import slot_slices, split
from firedancer_tpu_torch.utils.ed25519_ref import keypair, sign

SEED = bytes(range(32))
PUB = keypair(SEED)[-1]
HPT = 8
GENESIS = {keypair(synth_signer_seed(i))[-1]: 1 << 44 for i in range(16)}
COMMON = ("slices", "slots_replayed", "entries", "txns", "exec_ok",
          "exec_fail", "poh_fail", "buffered", "waves", "parse_fail",
          "divergent_slot", "behind")


class Capture:
    def __init__(self):
        self.frames = []

    def publish(self, frame, sig=0):
        self.frames.append(bytes(frame))

    def credits(self, fseqs):
        return 1 << 30


def _frame(slot, tick, num_hashes, prev, h, mixin, txns=(), done=False):
    blob = b"".join(struct.pack("<H", len(t)) + t for t in txns)
    return (struct.pack("<QIIB", slot, tick, num_hashes, 1 if txns else 0)
            + prev + h + mixin + bytes([1 if done else 0])
            + struct.pack("<H", len(txns)) + blob)


def leader_wires(groups_by_slot, n_slots, flush_bytes=31840):
    """Poh entry frames of `n_slots` slots (txn groups mixed in, then two
    ticks of HPT hashes) through the port's ShredLeaderCore. -> the
    turbine wires, in send order."""
    sent = []

    class Sock:
        def sendto(self, wire, addr):
            sent.append(bytes(wire))
    core = tshred.ShredLeaderCore(
        lambda r: sign(SEED, r), PUB, [ClusterNode(b"\x55" * 32, 100,
                                                   ("127.0.0.1", 9))],
        Sock(), flush_bytes=flush_bytes)
    state = bytes(32)
    for slot in range(n_slots):
        hashes = 0
        for txns in groups_by_slot.get(slot, []):
            mixin = hashlib.sha256(b"".join(t[1:65] for t in txns)).digest()
            prev, state = state, host_poh_mixin(state, mixin)
            hashes += 1
            core.on_entry(_frame(slot, 0, 1, prev, state, mixin, txns))
        for tick in range(2):
            prev, state = state, host_poh_append(state, HPT - hashes)
            core.on_entry(_frame(slot, tick, HPT - hashes, prev, state,
                                 bytes(32), done=tick == 1))
            hashes = 0
    return sent


@pytest.fixture(scope="module")
def run():
    """Six slots: empty ones, one txn group, a slot of 5 groups cut into
    slices (flush_bytes), a slot of 40 txns over two FEC sets."""
    txns = make_signed_txns(80, seed=6)
    groups = {1: [txns[:2]], 2: [txns[2 + 6 * i:8 + 6 * i]
                                 for i in range(5)],
              4: [txns[32:72]], 5: [txns[72:]]}
    wires = leader_wires(groups, 6, flush_bytes=2500)
    slices = {}
    for name, mod in (("ref", jshred), ("port", tshred)):
        out = Capture()
        core = mod.ShredRecoverCore(PUB, out, None)
        for w in wires:
            core.on_shred(w)
        slices[name] = (out.frames, dict(core.metrics))
    return wires, slices


def test_recovered_slices_match_reference(run):
    wires, slices = run
    assert slices["port"] == slices["ref"]
    frames, m = slices["port"]
    assert m["slots_done"] == 6 and m["slices"] > 6 and m["parse_fail"] == 0


def test_recovery_from_parity_gives_the_same_slices(run):
    """Every set loses as many data shreds as it has parity shreds, at most
    all its data; both packages recover the same slices."""
    wires, slices = run
    sets = {}
    for i, w in enumerate(wires):
        s = fmt.parse_shred(w)
        e = sets.setdefault((s.slot, s.fec_set_idx), [[], 0])
        if fmt.is_data(w[fmt.VARIANT_OFF]):
            e[0].append(i)
        else:
            e[1] += 1
    drop = {i for data, p in sets.values() for i in data[:p]}
    got = []
    for mod in (jshred, tshred):
        out = Capture()
        core = mod.ShredRecoverCore(PUB, out, None)
        for i, w in enumerate(wires):
            if i not in drop:
                core.on_shred(w)
        got.append((out.frames, core.resolver.metrics["recovered"]))
    assert got[1] == got[0]
    assert got[1][0] == slices["port"][0] and got[1][1] == len(drop) > 0


def _replay_both(frames, order=None, **kw):
    cores = (jreplay.ReplayCore(out_ring=Capture(), genesis=GENESIS,
                                hashes_per_tick=HPT, **kw),
             treplay.ReplayCore(out_ring=Capture(), genesis=GENESIS,
                                hashes_per_tick=HPT, device="cpu", **kw))
    for f in (frames if order is None else [frames[i] for i in order]):
        for c in cores:
            c.on_slice(f)
    return cores


def _same(ref, port):
    assert port.bank_hash_of == ref.bank_hash_of
    assert port.hash_of == ref.hash_of
    assert port.out_ring.frames == ref.out_ring.frames
    assert {k: port.metrics[k] for k in COMMON} == \
        {k: ref.metrics[k] for k in COMMON}


def test_replay_matches_reference(run):
    frames = run[1]["port"][0]
    ref, port = _replay_both(frames)
    _same(ref, port)
    m = port.metrics
    assert m["slots_replayed"] == 6 and m["poh_fail"] == 0
    assert m["txns"] == 80 and m["exec_ok"] == 80 and m["entries"] > 12
    # block frames: the slot's bank hash, parent links chained
    blocks = [parse_block(f) for f in port.out_ring.frames]
    assert [b[0] for b in blocks] == list(range(6))
    for (slot, parent, bid, pid), prev in zip(blocks[1:], blocks):
        assert parent == slot - 1 and pid == prev[2]
    assert pack_block(*blocks[3]) == port.out_ring.frames[3]


def test_one_release_equals_a_slice_at_a_time(run):
    """on_slices (the tile's poll: the release's PoH checks as one batch)
    gives what the reference's slice-at-a-time replay gives."""
    frames = run[1]["port"][0]
    ref, _ = _replay_both(frames)
    port = treplay.ReplayCore(out_ring=Capture(), genesis=GENESIS,
                              hashes_per_tick=HPT, device="cpu")
    spans = []
    assert port.on_slices(frames[:3]) + port.on_slices(frames[3:]) == 6
    _same(ref, port)
    port2 = treplay.ReplayCore(genesis=GENESIS, hashes_per_tick=HPT,
                               device="cpu",
                               on_span=lambda k, ns: spans.append(k))
    port2.on_slices(frames)
    assert port2.bank_hash_of == ref.bank_hash_of
    assert spans.count("poh") == 1 and spans.count("bank_hash") == 4


def test_out_of_order_slots_buffer_as_the_reference(run):
    frames = run[1]["port"][0]
    slot_of = [tshred.parse_slice(f)[0] for f in frames]
    first1 = slot_of.index(1)
    later = [i for i, s in enumerate(slot_of) if s != 1]
    order = later[:1] + later[1:] + [i for i, s in enumerate(slot_of)
                                     if s == 1]
    assert order[1] > first1
    ref, port = _replay_both(frames, order[:-1])
    _same(ref, port)
    assert port.metrics["slots_replayed"] == 1
    assert port.metrics["buffered"] == 4 and port.metrics["behind"] == 5
    for c in (ref, port):
        c.on_slice(frames[order[-1]])
    _same(ref, port)
    assert port.metrics["slots_replayed"] == 6


@pytest.mark.parametrize("slot", [2, 4])
def test_poh_tamper_is_caught_as_the_reference(run, slot):
    """A flipped byte in the first entry hash of a slot's first slice
    (slice header 13 + num_hashes 4)."""
    frames = [bytearray(f) for f in run[1]["port"][0]]
    k = [tshred.parse_slice(bytes(f))[0] for f in frames].index(slot)
    frames[k][17] ^= 1
    ref, port = _replay_both([bytes(f) for f in frames])
    _same(ref, port)
    assert port.metrics["poh_fail"] >= 1


def test_expected_mismatch_raises_in_both(run):
    frames = run[1]["port"][0]
    ref, _ = _replay_both(frames[:2])
    bad = {1: bytes(32)}
    for mod, kw in ((jreplay, {}), (treplay, {"device": "cpu"})):
        core = mod.ReplayCore(genesis=GENESIS, hashes_per_tick=HPT,
                              expected=bad, **kw)
        with pytest.raises(RuntimeError, match="divergence at slot 1"):
            for f in frames:
                core.on_slice(f)
        assert core.metrics["divergent_slot"] == 1
        assert core.bank_hash_of[0] == ref.bank_hash_of[0]
    good = treplay.ReplayCore(genesis=GENESIS, hashes_per_tick=HPT,
                              device="cpu", expected=dict(
                                  ref.bank_hash_of))
    for f in frames[:2]:
        good.on_slice(f)
    assert good.metrics["divergent_slot"] == 0


def test_normalize_replay_matches_reference_and_refuses_the_fanout():
    """The [replay] section as the reference takes it: the fan-out's
    `exec_tile_cnt` and `redispatch_s` are accepted, and a bad value of
    either raises ValueError in both packages."""
    for spec in (None, {}, {"hashes_per_tick": 64, "verify_poh": False},
                 {"exec_tile_cnt": 0}, {"exec_tile_cnt": 2},
                 {"redispatch_s": 1.0}, {"redispatch_s": "3"},
                 {"exec_tile_cnt": 4, "redispatch_s": 0.5}):
        assert treplay.normalize_replay(spec) == \
            jreplay.normalize_replay(spec)
    with pytest.raises(ValueError, match="did you mean 'hashes_per_tick'"):
        treplay.normalize_replay({"hashes_per_tik": 3})
    for bad in ({"hashes_per_tick": 0}, {"redispatch_s": 0},
                {"redispatch_s": -1.0}, {"exec_tile_cnt": -1}):
        for mod in (treplay, jreplay):
            with pytest.raises(ValueError):
                mod.normalize_replay(bad)


@pytest.fixture
def wksp():
    w = trt.Workspace(f"/fdtt_rp{os.getpid()}", 1 << 24)
    yield w
    w.close()
    w.unlink()


def _ctx(w, ins, outs, plan=None):
    rings = {ln: trt.Ring.create(w, depth=d, mtu=m)
             for ln, (d, m) in {**ins, **outs}.items()}
    return SimpleNamespace(
        tile_name="t", plan={"links": {ln: {"mtu": m} for ln, (_, m) in
                                       {**ins, **outs}.items()},
                             **(plan or {})},
        in_rings={ln: rings[ln] for ln in ins},
        out_rings={ln: rings[ln] for ln in outs},
        out_fseqs={ln: [] for ln in outs}, in_seq0={ln: 0 for ln in ins})


def _drain(ring):
    out, seq = [], 0
    while (got := ring.consume(seq))[0] == 0:
        out.append(bytes(ring.payload(got[1])))
        seq += 1
    return out


def test_adapters_recover_and_replay_over_rings(wksp, run):
    """ShredAdapter mode="recover" over a wire ring gives the reference
    core's slices; ReplayAdapter on the CPU over a slice ring gives the
    reference core's tower frames, takes hashes_per_tick from the plan's
    [replay] section, and reports its metrics."""
    wires, slices = run
    sh = ttiles.REGISTRY["shred"](_ctx(wksp, {"wires": (1024, 1280)},
                                       {"slices": (64, 1 << 16)}),
                                  {"mode": "recover",
                                   "leader_pubkey_hex": PUB.hex()})
    for w in wires:
        sh.ctx.in_rings["wires"].publish(w)
    assert sum(sh.poll_once() for _ in range(len(wires))) == len(wires)
    got = _drain(sh.ctx.out_rings["slices"])
    assert got == slices["ref"][0]
    assert sh.metrics_items()["slots_done"] == 6
    assert sh.in_seqs() == {"wires": len(wires)}
    rp = ttiles.REGISTRY["replay"](
        _ctx(wksp, {"slices": (64, 1 << 16)}, {"tower": (64, 128)},
             plan={"replay": treplay.normalize_replay(
                 {"hashes_per_tick": HPT})}),
        {"genesis": {k.hex(): v for k, v in GENESIS.items()},
         "device": "cpu"})
    for f in got:
        rp.ctx.in_rings["slices"].publish(f)
    while rp.poll_once():
        pass
    ref, _ = _replay_both(got)
    assert _drain(rp.ctx.out_rings["tower"]) == ref.out_ring.frames
    m = rp.metrics_items()
    assert set(m) == set(ttiles.REGISTRY["replay"].METRICS)
    assert m["slots_replayed"] == 6 and m["poh_fail"] == 0
    assert rp.tpu_hist.count > 0


@pytest.mark.parametrize("arg", [
    {"exec_links": ["x"]}, {"exec_done": ["x"]}, {"redispatch_s": 2.0},
    {"wait_restore": True}, {"snapshot_path": "s.bin"},
    {"snapshot_every": 4}, {"snapshot_compress": True}])
def test_replay_adapter_refuses_fanout_and_snapshots_with_item_5(wksp,
                                                                 arg):
    """The fan-out's args are the reference's: `exec_links` without a shm
    store is the reference's ValueError, and `exec_done` or
    `redispatch_s` alone change nothing. The snapshot restore and writer
    (item 5f) are ported: each arg reaches the core as the reference's
    adapter passes it (tests/test_torch_catchup.py drives them)."""
    def make():
        return ttiles.REGISTRY["replay"](
            _ctx(wksp, {"slices": (16, 1 << 16)}, {"tower": (16, 128)}),
            {"device": "cpu", **arg})
    if "exec_links" in arg:
        with pytest.raises(ValueError, match="need \\[funk\\] backend"):
            make()
    elif "exec_done" in arg or "redispatch_s" in arg:
        assert make().core.fanout is None
    else:
        core = make().core
        key, val = next(iter(arg.items()))
        assert getattr(core, key) == val
        assert core.waiting == (key == "wait_restore")


def test_replay_adapter_on_the_card_without_one_fails_its_boot(wksp):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttiles.REGISTRY["replay"](
            _ctx(wksp, {"slices": (16, 1 << 16)}, {"tower": (16, 128)}),
            {"genesis_synth": 16})


# -- the exec fan-out ---------------------------------------------------

def test_replay_fanout_bank_hashes_match_reference(wksp):
    """Eight slots of signed transfers through ReplayCore over ExecFanout
    and two exec shards (tools/exec_drills.replay_fanout: every slot's
    bank hash equal to the port's InlineFanout, balances exactly once)
    give the reference InlineFanout oracle's bank hash in every slot
    (tests/test_follower.py's harness)."""
    from test_follower import _mk_oracle, _slot_slices
    txns = make_signed_txns(64, seed=47)
    got = exec_drills.replay_fanout(wksp, txns, 8, device="cpu")
    oracle = _mk_oracle({k: v for k, v in GENESIS.items()
                         if k in _genesis8()})
    slices = _slot_slices(txns, 8)
    assert slices == slot_slices(split(txns, 8), b"fo-tip-")
    for s in range(1, 9):
        oracle.on_slice(slices[s])
    assert got["bank_hashes"] == {s: oracle.bank_hash_of[s]
                                  for s in range(1, 9)}
    assert got["exec_waves"] == 8 and got["exec_redispatch"] == 0
    assert min(got["shard_txns"]) > 0


def test_follower_exec_shard_death_redispatch(wksp):
    """The reference's drill (tests/test_follower.py): shard 0 dead at
    dispatch, so the deadline cancels the fork and redispatches under a
    fresh one; when the shard rejoins (its ring re-read from seq 0) it
    abandons the cancelled forks' frames, the wave completes, the slot's
    bank hash is the reference oracle's and balances come out once."""
    from test_follower import _mk_oracle, _slot_slices
    txns = make_signed_txns(8, seed=47)
    got = exec_drills.replay_fanout(wksp, txns, 1, device="cpu",
                                    dead_shard_s=1.0, redispatch_s=0.3)
    oracle = _mk_oracle({k: v for k, v in GENESIS.items()
                         if k in _genesis8()})
    oracle.on_slice(_slot_slices(txns, 1)[1])
    assert got["bank_hashes"] == {1: oracle.bank_hash_of[1]}
    assert got["exec_redispatch"] >= 1 and got["stale_xid"] >= 1


def _genesis8():
    return {keypair(synth_signer_seed(i))[-1] for i in range(8)}


def test_replay_adapter_fanout_over_rings_matches_reference(wksp, run):
    """ReplayAdapter with `exec_links` over two ExecAdapters (polled on
    threads) and the plan's shm store, PoH verified, on the run's
    slices: the tower frames and bank hashes of the reference's
    ReplayCore over InlineFanout, the fan-out's counts in the tile's
    metrics."""
    from firedancer_tpu.funk.funk import Funk as JFunk
    frames = run[1]["port"][0]
    jf = JFunk()
    ref = jreplay.ReplayCore(out_ring=Capture(), genesis=GENESIS,
                             hashes_per_tick=HPT, funk=jf,
                             fanout=jreplay.InlineFanout(jf))
    for f in frames:
        ref.on_slice(f)
    funk_plan = exec_drills.store_plan(wksp)
    ins = {"slices": (64, 1 << 16), "exec_done0": (64, 64),
           "exec_done1": (64, 64)}
    outs = {"tower": (64, 128), "exec_disp0": (64, 4096),
            "exec_disp1": (64, 4096)}
    ctx = _ctx(wksp, ins, outs, plan={"funk": funk_plan, "replay":
                                      treplay.normalize_replay(
                                          {"hashes_per_tick": HPT})})
    ctx.wksp = wksp
    rp = ttiles.REGISTRY["replay"](ctx, {
        "genesis": {k.hex(): v for k, v in GENESIS.items()},
        "device": "cpu", "exec_links": ["exec_disp0", "exec_disp1"],
        "exec_done": ["exec_done0", "exec_done1"]})
    rings = {**ctx.in_rings, **ctx.out_rings}
    shards = exec_drills.ShardThreads()
    for i in range(2):
        shards.run(ttiles.REGISTRY["exec"](exec_drills.exec_ctx(
            wksp, ctx.plan, rings, i), {"device": "cpu"}))
    try:
        for f in frames:
            ctx.in_rings["slices"].publish(f)
        while rp.poll_once():
            pass
    finally:
        shards.join()
    assert _drain(ctx.out_rings["tower"]) == ref.out_ring.frames
    assert rp.core.bank_hash_of == ref.bank_hash_of
    m = rp.metrics_items()
    assert set(m) == set(ttiles.REGISTRY["replay"].METRICS)
    assert m["slots_replayed"] == 6 and m["poh_fail"] == 0
    assert m["exec_ok"] == ref.metrics["exec_ok"] == 80
    assert m["exec_waves"] == 4 and m["exec_redispatch"] == 0
    assert rp.in_seqs()["exec_done0"] + rp.in_seqs()["exec_done1"] >= 4


def test_v0_slices_replay_to_reference_bank_hashes(tmp_path):
    """The general workload (tools/general_exec.py, small) as slices with
    a real PoH chain: votes, TowerSync, stake, lookup-table and
    precompile txns, the designed failures, and v0 transfers that load
    their destinations through the genesis tables, replayed by both
    packages from one genesis checkpoint across an epoch boundary: equal
    bank hashes a slot, equal metrics and equal stores (exact)."""
    from firedancer_tpu.funk.funk import Funk as JFunk
    from firedancer_tpu.svm.accdb import Account as JAccount
    from firedancer_tpu.utils import checkpt as jcheckpt
    from firedancer_tpu_torch.funk.funk import Funk as TFunk
    from firedancer_tpu_torch.svm.accdb import Account as TAccount
    from firedancer_tpu_torch.tools import general_exec as gx
    from firedancer_tpu_torch.utils import checkpt as tcheckpt
    wl = gx.build(8, 8, tables=2, table_addrs=8, scale=0.1)
    genesis = gx.write_genesis(wl, str(tmp_path / "genesis.ckpt"))
    slices = gx.workload_slices(wl, 62, HPT)
    got = []
    for mod, ck, fk, acct, kw in (
            (jreplay, jcheckpt, JFunk, JAccount, {}),
            (treplay, tcheckpt, TFunk, TAccount, {"device": "cpu"})):
        with open(genesis, "rb") as f:
            funk = ck.funk_restore(fk, f)
        core = mod.ReplayCore(funk=funk, hashes_per_tick=HPT,
                              slots_per_epoch=64, verify_poh=False, **kw)
        for s in sorted(slices):
            core.on_slice(slices[s])
        got.append((dict(core.bank_hash_of),
                    {k: core.metrics[k] for k in COMMON},
                    {bytes(k): (v.lamports, bytes(v.data), v.owner)
                     for k, v in funk.root_items().items()
                     if isinstance(v, acct)}))
    assert got[1] == got[0]
    m = got[1][1]
    assert m["slots_replayed"] == 8 and m["exec_fail"] == wl.designed_fail
    assert m["txns"] == len(wl.traffic) + len(wl.v0)
