"""The leader's loop of the port against the JAX package's: the pack,
bank (exec="svm", device="cpu": the wave scan's plain version) and poh
adapters in-process over each package's own shm rings, fed the same
frames: every out frame byte-identical and every funk balance equal
(tests/test_leader_batch.py:120, :150, :232, :281, :348); then the port's
leader topology spawned on the CPU (tests/test_leader_batch.py:532), the
refusals and the exec fan-out's args taken as the reference takes them, cfg/leader.toml held to bench.py's `_leader_topology`, the whole
of cfg/leader.toml (shred, sign and shredsink included) drained on the
CPU, and `app.run` on cfg/leader.toml."""
import dataclasses
import hashlib
import os
import struct
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.tiles.synth import make_signed_txns, synth_signer_seed
from firedancer_tpu.utils.ed25519_ref import keypair
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.app import config as tconfig
from firedancer_tpu_torch.disco import tiles as ttiles
from firedancer_tpu_torch.disco.launch import TopologyRunner
from firedancer_tpu_torch.disco.topo import Topology
from firedancer_tpu_torch.tools import leader_drain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEADER_TOML = os.path.join(ROOT, "firedancer_tpu_torch", "cfg",
                           "leader.toml")
PKGS = ((jrt, jtiles), (trt, ttiles))       # reference, port


@pytest.fixture(scope="module")
def wksps():
    ws = (jrt.Workspace(f"/fdtpu_tl_{os.getpid()}", 1 << 25),
          trt.Workspace(f"/fdtt_tl_{os.getpid()}", 1 << 25))
    yield ws
    for w in ws:
        w.close()
        w.unlink()


class Rig:
    """One adapter of one package over fresh rings of its own runtime:
    ins and outs are {link: (depth, mtu)}; `fseq` names the out links
    with one reliable consumer (an Fseq the test advances)."""

    def __init__(self, rt, tiles, w, kind, args, ins, outs, fseq=()):
        self.rt = rt
        self.rings = {ln: rt.Ring.create(w, depth=d, mtu=m)
                      for ln, (d, m) in {**ins, **outs}.items()}
        self.fseqs = {ln: rt.Fseq(w) for ln in fseq}
        ctx = SimpleNamespace(
            tile_name=kind, plan={"links": {ln: {"mtu": m} for ln, (_, m)
                                            in {**ins, **outs}.items()}},
            in_rings={ln: self.rings[ln] for ln in ins},
            out_rings={ln: self.rings[ln] for ln in outs},
            out_fseqs={ln: [self.fseqs[ln]] if ln in self.fseqs else []
                       for ln in outs},
            in_seq0={ln: 0 for ln in ins},
            in_seqs0=lambda: {ln: 0 for ln in ins})
        self.tile = tiles.REGISTRY[kind](ctx, args)
        self.seq = {ln: 0 for ln in outs}

    def publish(self, ln, payload, sig):
        self.rings[ln].publish(payload, sig=sig)

    def drain(self, ln):
        """(payload, sig) of the frags published on `ln` since the last
        drain."""
        out, ring = [], self.rings[ln]
        while True:
            rc, frag = ring.consume(self.seq[ln])
            if rc != 0:
                return out
            out.append((bytes(ring.payload(frag)), int(frag.sig)))
            self.seq[ln] += 1


def _pair(wksps, kind, args, ins, outs, fseq=(), port_args=None):
    return [Rig(rt, tiles, w, kind, a, ins, outs, fseq)
            for (rt, tiles), w, a in zip(PKGS, wksps,
                                         (args, port_args or args))]


def _same(rigs, ln):
    got = [r.drain(ln) for r in rigs]
    assert got[1] == got[0], ln
    return got[1]


# -- pack ---------------------------------------------------------------

PACK_LINKS = dict(ins={"txns": (256, 1280), "done0": (64, 64),
                       "slots": (16, 64)},
                  outs={"bank0": (64, 16384)})
PACK_ARGS = {"txn_in": "txns", "bank_links": ["bank0"],
             "done_links": ["done0"], "slot_in": "slots",
             "max_txn_per_microblock": 31, "wave": 4, "batch": 256}


def test_pack_adapter_frames_match_reference(wksps):
    """Waves of microblocks from synth transfers (16 signers, so
    conflicts bound each microblock), completions retiring them, slot
    frags advancing the slot in the header, an unparseable payload:
    every bank-link frame, its sig and every metric equal
    (tests/test_leader_batch.py:232)."""
    rigs = _pair(wksps, "pack", PACK_ARGS, **PACK_LINKS)
    txns = make_signed_txns(96, seed=21)
    for r in rigs:
        for i, t in enumerate(txns[:60]):
            r.publish("txns", t, i)
        r.publish("txns", b"\x05" * 40, 60)
    seen = []
    for rnd in range(8):
        for r in rigs:
            r.tile.poll_once()
        frames = _same(rigs, "bank0")
        seen += frames
        for r in rigs:
            for _, mb in frames:
                r.publish("done0", struct.pack("<Q", mb), mb)
            if rnd == 2:
                r.publish("slots", struct.pack("<Q", 0), 0)
                for i, t in enumerate(txns[60:]):
                    r.publish("txns", t, 61 + i)
    m = rigs[1].tile.m
    assert {k: rigs[0].tile.m[k] for k in m} == m
    assert m["parse_fail"] == 1 and m["blocks"] == 1
    assert m["scheduled"] == len(txns) == sum(
        struct.unpack_from("<H", f, 2)[0] for f, _ in seen)
    assert {struct.unpack_from("<Q", f, 12)[0] for f, _ in seen} == {0, 1}


def test_pack_wave_respects_credit_window(wksps):
    """With a reliable bank consumer that never advances, only the
    link's credits' worth of microblocks is scheduled, on both
    (tests/test_leader_batch.py:281)."""
    links = dict(ins={"txns": (256, 1280), "done0": (64, 64)},
                 outs={"bank0": (2, 16384)})
    args = {"txn_in": "txns", "bank_links": ["bank0"],
            "done_links": ["done0"], "max_txn_per_microblock": 1,
            "wave": 8, "slot_ms": 1e9}
    rigs = _pair(wksps, "pack", args, fseq=("bank0",), **links)
    for r in rigs:
        for i, t in enumerate(make_signed_txns(8, seed=23)):
            r.publish("txns", t, i)
        r.tile.poll_once()
        assert len(r.tile.busy[0]) == 2 and r.rings["bank0"].seq == 2
    _same(rigs, "bank0")


# -- bank ---------------------------------------------------------------

BANK_LINKS = dict(ins={"mb": (64, 16384)},
                  outs={"done": (64, 64), "poh": (64, 16448)})


def _microblock(mb_id, slot, payloads):
    out = bytearray(struct.pack("<HHQQ", 0, len(payloads), mb_id, slot))
    for p in payloads:
        out += struct.pack("<H", len(p)) + p
    return bytes(out)


def test_bank_adapter_frames_and_balances_match_reference(wksps):
    """The same microblocks through the reference's bank (jitted scan)
    and the port's (device="cpu"), pipelined over waves of up to 4
    microblocks: completion and poh frames byte-identical (mixin and
    forwarded payloads), equal metrics, and equal funk balances. Signers
    8-11 cannot pay the fee and 12-15 only the fee; one payload does not
    parse and one microblock is empty."""
    pubs = [keypair(synth_signer_seed(i))[-1] for i in range(16)]
    genesis = {p.hex(): (1 << 44 if i < 8 else 3000 if i < 12 else 6000)
               for i, p in enumerate(pubs)}
    args = {"exec": "svm", "wave": 4, "poh_link": "poh",
            "forward_payloads": True, "genesis": genesis}
    rigs = _pair(wksps, "bank", args, **BANK_LINKS,
                 port_args={**args, "device": "cpu"})
    txns = make_signed_txns(64, seed=5)
    blocks = [txns[i:i + 16] for i in range(0, 64, 16)]
    blocks.insert(2, [])
    blocks[1] = blocks[1][:5] + [b"\x07" * 50] + blocks[1][5:]
    for r in rigs:
        for k, blk in enumerate(blocks):
            r.publish("mb", _microblock(k, k // 2, blk), k)
        for burst in (2, 0, 9, 0):
            for _ in range(max(1, burst)):
                r.tile.poll_once()
        r.tile.on_halt()
    done = _same(rigs, "done")
    poh = _same(rigs, "poh")
    assert [sig for _, sig in done] == list(range(len(blocks)))
    assert len(poh) == len(blocks) - 1           # the empty one has none
    f, mb = poh[0]
    assert f[10:42] == hashlib.sha256(b"".join(
        t[1:65] for t in blocks[0])).digest()
    assert f[42:] == _microblock(0, 0, blocks[0])[20:]
    mj, mt = rigs[0].tile.m, rigs[1].tile.m
    assert {k: mj[k] for k in mt if k in mj} == \
        {k: v for k, v in mt.items() if k != "wave_launches"}
    assert mt["transfers"] == 32 and mt["exec_fail"] == 32
    assert mt["exec_skip"] == 1 and mt["wave_launches"] == 0
    assert rigs[1].tile.funk.root_items() == rigs[0].tile.funk.root_items()


def test_bank_stub_acks_every_microblock(wksps):
    rigs = _pair(wksps, "bank", {"exec": "stub"}, ins={"mb": (16, 1024)},
                 outs={"done": (16, 64)})
    for r in rigs:
        for k in range(3):
            r.publish("mb", _microblock(k, 0, [b"x"]), k)
        r.tile.poll_once()
    assert [s for _, s in _same(rigs, "done")] == [0, 1, 2]


# -- poh ----------------------------------------------------------------

POH_LINKS = dict(ins={"in": (64, 256)},
                 outs={"entries": (256, 512), "slots": (64, 64)})


def test_poh_adapter_frames_match_reference(wksps):
    """Uneven waves of bank frames (runs crossing tick boundaries) and
    housekeeping ticks: every entry frame and slot frag equal
    (tests/test_leader_batch.py:120)."""
    args = {"hashes_per_tick": 4, "ticks_per_slot": 2,
            "slot_link": "slots", "seed": "11" * 32}
    rigs = _pair(wksps, "poh", args, **POH_LINKS)
    for r in rigs:
        sent = 0
        for burst in (1, 4, 6, 0, 3):
            for _ in range(burst):
                mixin = hashlib.sha256(b"mb-%d" % sent).digest()
                blob = (b"\x05\x00" + bytes([sent]) * 5) if sent % 3 \
                    else b""
                r.publish("in", struct.pack("<QH", sent, 1 if blob else 0)
                          + mixin + blob, sent)
                sent += 1
            r.tile.poll_once()
            if burst in (4, 0):
                r.tile.housekeeping()
        r.tile.on_halt()
    entries = _same(rigs, "entries")
    slots = _same(rigs, "slots")
    assert rigs[1].tile.m == rigs[0].tile.m
    assert rigs[1].tile.m["mixins"] == 14 and len(entries) > 14
    assert [s for _, s in slots] == list(range(len(slots))) and slots


def test_poh_wave_backpressure_resumes_exact(wksps):
    """A reliable consumer slower than the wave: the batched entry
    publish stalls mid-wave and resumes from the stop row; the consumer
    sees the reference's frames, none lost or reordered
    (tests/test_leader_batch.py:150)."""
    rigs = _pair(wksps, "poh", {"hashes_per_tick": 64, "ticks_per_slot": 8},
                 ins={"in": (64, 256)}, outs={"entries": (8, 512)},
                 fseq=("entries",))
    got = []
    for r in rigs:
        for i in range(12):
            r.publish("in", struct.pack("<QH", i, 0)
                      + hashlib.sha256(b"bp-%d" % i).digest(), i)
        out = []

        def consume(r=r, out=out):
            seq, ring = 0, r.rings["entries"]
            deadline = time.monotonic() + 30
            while len(out) < 12 and time.monotonic() < deadline:
                rc, frag = ring.consume(seq)
                if rc != 0:
                    time.sleep(0.002)
                    continue
                out.append(bytes(ring.payload(frag)))
                seq += 1
                r.fseqs["entries"].update(seq)
                time.sleep(0.001)
        t = threading.Thread(target=consume)
        t.start()
        r.tile.poll_once()
        t.join(timeout=30)
        assert not t.is_alive()
        got.append(out)
    assert got[1] == got[0] and len(got[1]) == 12
    assert rigs[1].tile.m["backpressure"] >= 1


# -- refusals -----------------------------------------------------------

@pytest.mark.parametrize("kind,arg,item", [
    ("bank", {"genesis_ckpt": "g.bin"}, "5f"),
    ("bank", {"rpc_port": 0}, 16),
    ("bank", {"ws_port": 0}, 16),
    ("pack", {"bundle_in": "bundles"}, 13)])
def test_unported_adapter_arg_is_refused_with_its_item(wksps, kind, arg,
                                                       item):
    """Each refused arg names its queue-A item. The bank's genesis_ckpt
    (item 5f) is ported: the adapter opens the checkpoint, so a missing
    file raises the reference's FileNotFoundError
    (tests/test_torch_exec_tile.py boots from a real one)."""
    links = BANK_LINKS if kind == "bank" else PACK_LINKS
    args = {**({"exec": "svm"} if kind == "bank" else PACK_ARGS), **arg}
    if item == "5f":
        with pytest.raises(FileNotFoundError, match="g.bin"):
            Rig(trt, ttiles, wksps[1], kind, {**args, "device": "cpu",
                                              "poh_link": "poh"}, **links)
        return
    with pytest.raises(NotImplementedError,
                       match=f"queue A item {item}$"):
        Rig(trt, ttiles, wksps[1], kind, args, **links)


@pytest.mark.parametrize("kind,arg", [
    ("bank", {"exec_links": ["poh"]}), ("bank", {"exec_done": ["mb"]}),
    ("bank", {"redispatch_s": 2.0}), ("pack", {"resolved_in": True})])
def test_ported_fanout_arg_acts_as_the_reference(wksps, kind, arg):
    """The args the exec tile family brought (tests/test_torch_exec_tile.py
    drives them): both packages' adapters take them alike. An
    `exec_links` or `exec_done` without its pair raises the reference's
    ValueError; a lone `redispatch_s` and pack's `resolved_in` build."""
    links = BANK_LINKS if kind == "bank" else PACK_LINKS
    args = {**({"exec": "svm", "poh_link": "poh"} if kind == "bank"
               else PACK_ARGS), **arg}
    got = []
    for (rt, tiles), w, a in zip(PKGS, wksps, (args, {
            **args, **({"device": "cpu"} if kind == "bank" else {})})):
        try:
            Rig(rt, tiles, w, kind, a, **links)
            got.append("ok")
        except ValueError as e:
            got.append(str(e))
    assert got[1] == got[0]
    assert (got[1] == "ok") == ("redispatch_s" in arg
                                or "resolved_in" in arg)


def test_bank_on_the_card_without_one_raises(wksps):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Rig(trt, ttiles, wksps[1], "bank",
            {"exec": "svm", "poh_link": "poh"}, **BANK_LINKS)


# -- processes ----------------------------------------------------------

def test_leader_loop_with_two_verify_tiles_on_the_cpu():
    """The full leader leg as spawned tile processes (synth -> verify x2
    rr-sharded -> dedup -> pack -> bank(svm waves) -> poh -> sink), with
    verify and bank on the CPU: every funded transfer executes exactly
    once, poh mixes every microblock, and both shards carry traffic
    (tests/test_leader_batch.py:532)."""
    n = 24
    genesis = {keypair(synth_signer_seed(i))[-1].hex(): 1 << 44
               for i in range(16)}
    topo = (
        Topology(f"tl2v{os.getpid()}", wksp_size=1 << 25)
        .link("ingest", depth=128, mtu=1280)
        .link("vd0", depth=128, mtu=1280)
        .link("vd1", depth=128, mtu=1280)
        .link("dedup_pack", depth=128, mtu=1280)
        .link("pack_bank0", depth=32, mtu=1 << 15)
        .link("bank0_done", depth=32, mtu=64)
        .link("bank0_poh", depth=64, mtu=64)
        .link("poh_entries", depth=2048, mtu=256)
        .link("poh_slots", depth=64, mtu=64)
        .tcache("vtc0", depth=4096).tcache("vtc1", depth=4096)
        .tcache("dedup_tc", depth=4096)
        .tile("synth", "synth", outs=["ingest"], count=n, unique=n,
              seed=6)
        .sharded_tile("verify", "verify", 2, ins=["ingest"],
                      outs=["vd0", "vd1"], batch=16,
                      tcache=["vtc0", "vtc1"], device="cpu")
        .tile("dedup", "dedup", ins=["vd0", "vd1"],
              outs=["dedup_pack"], tcache="dedup_tc")
        .tile("pack", "pack",
              ins=["dedup_pack", "bank0_done", "poh_slots"],
              outs=["pack_bank0"], txn_in="dedup_pack",
              bank_links=["pack_bank0"], done_links=["bank0_done"],
              slot_in="poh_slots", max_txn_per_microblock=8, wave=4)
        .tile("bank0", "bank", ins=["pack_bank0"],
              outs=["bank0_done", "bank0_poh"], exec="svm", wave=4,
              poh_link="bank0_poh", genesis=genesis, device="cpu")
        .tile("poh", "poh", ins=["bank0_poh"],
              outs=["poh_entries", "poh_slots"],
              slot_link="poh_slots", hashes_per_tick=16,
              ticks_per_slot=4)
        .tile("entsink", "sink", ins=["poh_entries"]))
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=120)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            runner.check_failures()
            b = runner.metrics("bank0")
            if b["transfers"] == n and runner.metrics("poh")["mixins"] \
                    == b["microblocks"] and \
                    runner.metrics("pack")["completions"] \
                    == runner.metrics("pack")["microblocks"]:
                break
            time.sleep(0.05)
        b = runner.metrics("bank0")
        assert b["transfers"] == n and b["exec_fail"] == 0
        assert b["txns"] == n and b["wave_launches"] == 0
        v0, v1 = (runner.metrics(f"verify{i}") for i in (0, 1))
        assert v0["rx"] + v1["rx"] == n
        assert v0["rx"] > 0 and v1["rx"] > 0
        assert v0["verify_fail"] == v1["verify_fail"] == 0
        assert runner.metrics("dedup")["tx"] == n
        assert runner.metrics("poh")["mixins"] == b["microblocks"]
    finally:
        runner.halt()
        runner.close()


def _specs(topo) -> dict:
    return {"links": {n: dataclasses.asdict(s)
                      for n, s in topo.links.items()},
            "tcaches": dict(topo.tcaches),
            "tiles": {n: dataclasses.asdict(s)
                      for n, s in topo.tiles.items()}}


def test_leader_toml_is_bench_leader_topology_less_core_pinning():
    """bench.py's leader topology at its capacity boot (4096 frames over
    768 unique, batch 32, two verify shards, unpaced) and
    cfg/leader.toml build the same links, tcaches and tiles, but for the
    verify shards' core pinning (cpu_idx) and the synth's rate_tps None
    (unpaced), which the TOML leaves out."""
    sys.path.insert(0, ROOT)
    import bench
    want = _specs(bench._leader_topology(4096, 768, 32, 2, None))
    got = _specs(tconfig.build_topology(tconfig.load_config(LEADER_TOML)))
    for t in want["tiles"].values():
        t["args"].pop("cpu_idx", None)
    assert want["tiles"]["synth"]["args"].pop("rate_tps") is None
    assert got == want
    assert {"shred", "sign", "shredsink"} <= set(got["tiles"])


def test_full_leader_toml_drains_on_the_cpu():
    """cfg/leader.toml with the shred leg, verify and bank on the CPU, at
    192 frames over 64 unique txns: bench.py's conservation rule holds,
    the shred leg drains, shredsink has every shred the shred tile made,
    the sign tile signed one root a FEC set and refused none, and every
    mirrored shred proves its set's root, which its signature covers."""
    cfg = tconfig.load_config(LEADER_TOML, overrides={"tile": [
        {"name": "synth", "count": 192, "unique": 64},
        {"name": "verify", "device": "cpu"},
        {"name": "bank0", "device": "cpu"}]})
    runner = TopologyRunner(tconfig.build_topology(
        cfg, name=f"tlf{os.getpid()}").build()).start()
    # every mirrored shred, read as it is published: the shred count
    # grows with the run's wall time, past the ring's depth under load
    tap = leader_drain.LinkTap(runner, "shreds_mirror")
    try:
        runner.wait_running(timeout_s=120)
        runner.wait_idle("synth", "tx", 192, timeout_s=120)
        drops = leader_drain.wait_drained(runner, 192, timeout_s=120)
        m = leader_drain.drain_shred_leg(runner, timeout_s=120)
        b, sh, sg = m["bank0"], m["shred"], m["sign"]
        assert b["txns"] + drops == 192 and b["exec_fail"] == 0
        assert m["poh"]["mixins"] == b["microblocks"] > 0
        assert sh["fec_sets"] > 0 and sh["sign_fail"] == 0
        assert m["shredsink"]["rx"] == sh["data_shreds"] \
            + sh["parity_shreds"] == sh["sent"] + sh["no_dest"]
        assert sg["signed"] == sh["fec_sets"] and sg["refused"] == 0
        assert sh["entries"] == m["poh"]["entries"]
        wires = tap.stop()
        assert len(wires) == m["shredsink"]["rx"]
        pub = bytes.fromhex(next(t["identity_hex"] for t in cfg["tile"]
                                 if t["name"] == "shred"))
        assert leader_drain.check_mirror(wires, pub) == sh["fec_sets"]
        for tn, p in runner.procs.items():
            assert p.exitcode == 0, (tn, p.exitcode)
    finally:
        tap.close()
        runner.halt()
        runner.close()


def _run(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.run", LEADER_TOML,
         "--interval", "60", *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=ROOT))


def test_app_run_boots_leader_toml_on_the_cpu():
    """synth, both verify shards, dedup, pack, bank0, poh, shred, sign and
    shredsink boot and run; the table lists every tile."""
    r = _run("--device", "cpu", "--duration", "2")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for tn in ("synth", "verify0", "verify1", "dedup", "pack", "bank0",
               "poh", "shred", "sign", "shredsink"):
        assert f"\n{tn} " in r.stdout, tn


def test_app_run_leader_toml_without_a_card_exits_1():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run("--duration", "2")
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
    assert "died" in r.stderr
