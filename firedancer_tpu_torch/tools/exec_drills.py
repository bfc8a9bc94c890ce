"""In-process drills of the exec tile family over real shm rings: the bank
(or the replay) with ExecFanout, N ExecAdapters sharing one carved store
(runtime.Store) in one workspace. chip_smoke.py phase 20a runs them on
the card (`device="cuda"`); tests/test_torch_exec_tile.py and
tests/test_torch_replay.py run them on the CPU beside the JAX package's
own harness (tests/test_exec_tile.py, tests/test_follower.py).

  byte_identity       the same microblock frames through the in-process
                      svm bank and through the fan-out over two exec
                      tiles: every poh frame, done frag and balance equal
  conflict_isolation  no account key in two shards' dispatch frames; a
                      conflict chain on one shard, in order; balances ==
                      execute_block_serial
  shard_death         shard 0 never drains: the wave does not publish on
                      a partial completion set; the deadline cancels the
                      fork and redispatches under a fresh one; restarted
                      shards abandon the cancelled fork's frames
                      (stale_xid) and complete the fresh ones: balances
                      exactly once
  replay_fanout       ReplayCore over ExecFanout and two shards (polled
                      on threads) against ReplayCore over InlineFanout:
                      the same bank hash every slot
  genesis_ckpt_boot   the in-process bank booted from a `genesis_ckpt`
                      of its genesis against the genesis-dict boot: the
                      same poh frames, done frags and balances, both on
                      `device`

Each returns a record of what it checked and raises AssertionError on a
mismatch.
"""
from __future__ import annotations

import hashlib
import struct
import threading
import time
from types import SimpleNamespace

from ..disco.tiles import (BankAdapter, ExecAdapter, ExecFanout,
                           _EXEC_HDR, _EXEC_TXN, _EXEC_TXN_SZ)
from ..funk.shmfunk import WireFunk
from ..ops import cuda_wave
from ..runtime import Ring, Store
from ..svm.executor import SystemTxn, execute_block_serial
from ..tiles.synth import synth_signer_seed
from ..utils.ed25519_ref import keypair
from .slices import slot_slices, split


def synth_genesis(n: int = 16) -> dict:
    """{pubkey hex: lamports} funding the first n synth signers."""
    return {keypair(synth_signer_seed(i))[-1].hex(): 1 << 44
            for i in range(n)}


def store_plan(wksp) -> dict:
    """Carve a store of 4096 recs, 64 txns and a 1 MiB heap into `wksp`;
    -> its plan["funk"] entry."""
    rec_max, txn_max, heap_sz = 4096, 64, 1 << 20
    st = Store(wksp, rec_max=rec_max, txn_max=txn_max, heap_sz=heap_sz)
    return {"backend": "shm", "rec_max": rec_max, "txn_max": txn_max,
            "heap_mb": max(1, heap_sz >> 20), "off": st.off,
            "heap_sz": heap_sz}


def microblocks(txns) -> list[bytes]:
    """Pack's microblock frames (u16 bank | u16 cnt | u64 id | u64 slot |
    (u16 len | payload)*), six txns each, in slot 3."""
    per, slot = 6, 3
    frames = []
    for mb_id in range(0, len(txns), per):
        chunk = txns[mb_id:mb_id + per]
        body = b"".join(struct.pack("<H", len(p)) + p for p in chunk)
        frames.append(struct.pack("<HHQQ", 0, len(chunk), mb_id // per,
                                  slot) + body)
    return frames


def drain(ring, seq: int = 0):
    """-> ([(payload, sig)], next seq) of every frame from `seq`."""
    out = []
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out, seq
        out.append((bytes(ring.payload(frag)), frag.sig))
        seq += 1


def exec_ctx(wksp, plan, rings, i: int, name: str | None = None):
    return SimpleNamespace(
        tile_name=name or f"exec{i}", plan=plan, wksp=wksp,
        in_rings={f"exec_disp{i}": rings[f"exec_disp{i}"]},
        out_rings={f"exec_done{i}": rings[f"exec_done{i}"]},
        out_fseqs={f"exec_done{i}": []}, in_seq0={})


def family(wksp, n_exec: int = 2, redispatch_s: float = 5.0,
           genesis=None, device="cuda"):
    """bank0 with `exec_links` over `n_exec` ExecAdapters. -> (bank,
    execs, rings)."""
    funk_plan = store_plan(wksp)
    links = {"pack_bank0": {"mtu": 1 << 15}, "bank0_done": {"mtu": 64},
             "bank0_poh": {"mtu": 1 << 16}}
    for i in range(n_exec):
        links[f"exec_disp{i}"] = {"mtu": 4096}
        links[f"exec_done{i}"] = {"mtu": 64}
    rings = {ln: Ring.create(wksp, depth=64, mtu=li["mtu"])
             for ln, li in links.items()}
    plan = {"links": links, "funk": funk_plan}
    bank_ctx = SimpleNamespace(
        tile_name="bank0", plan=plan, wksp=wksp,
        in_rings={"pack_bank0": rings["pack_bank0"],
                  **{f"exec_done{i}": rings[f"exec_done{i}"]
                     for i in range(n_exec)}},
        out_rings={"bank0_done": rings["bank0_done"],
                   "bank0_poh": rings["bank0_poh"],
                   **{f"exec_disp{i}": rings[f"exec_disp{i}"]
                      for i in range(n_exec)}},
        out_fseqs={ln: [] for ln in links}, in_seq0={})
    bank = BankAdapter(bank_ctx, {
        "exec": "svm", "wave": 8, "poh_link": "bank0_poh",
        "exec_links": [f"exec_disp{i}" for i in range(n_exec)],
        "exec_done": [f"exec_done{i}" for i in range(n_exec)],
        "genesis": genesis or {}, "forward_payloads": True,
        "redispatch_s": redispatch_s, "device": device})
    execs = [ExecAdapter(exec_ctx(wksp, plan, rings, i),
                         {"batch": 8, "device": device})
             for i in range(n_exec)]
    return bank, execs, rings


def in_process_bank(wksp, genesis, device="cpu", genesis_ckpt=None):
    """The exec="svm" bank without the fan-out, by default on the CPU
    (the plain wave scan: the fan-out's kernel is held to it, not to
    itself), booted from `genesis` or a `genesis_ckpt` file.
    -> (bank, rings)."""
    links = {"pb": {"mtu": 1 << 15}, "dn": {"mtu": 64},
             "ph": {"mtu": 1 << 16}}
    rings = {ln: Ring.create(wksp, depth=64, mtu=li["mtu"])
             for ln, li in links.items()}
    ctx = SimpleNamespace(
        tile_name="bankA", plan={"links": links},
        in_rings={"pb": rings["pb"]},
        out_rings={"dn": rings["dn"], "ph": rings["ph"]},
        out_fseqs={"dn": [], "ph": []}, in_seq0={})
    bank = BankAdapter(ctx, {"exec": "svm", "wave": 8, "poh_link": "ph",
                             "genesis": genesis, "forward_payloads": True,
                             "genesis_ckpt": genesis_ckpt,
                             "device": device})
    return bank, rings


def genesis_ckpt_boot(wksp, txns, path: str, device="cuda") -> dict:
    """Write the synth genesis as a funk checkpoint at `path` (the
    balances the bank's genesis dict would write), boot one bank from
    it and one from the dict, run the same microblocks through both on
    `device`: every poh frame, done frag and balance equal."""
    from ..funk.funk import Funk, key32
    from ..utils.checkpt import funk_checkpt
    genesis = synth_genesis()
    funk = Funk()
    for k, bal in genesis.items():
        funk.rec_write(None, key32(bytes.fromhex(k)), int(bal))
    with open(path, "wb") as f:
        funk_checkpt(funk, f)
    frames = microblocks(txns)
    out = []
    for kw in ({"genesis": genesis}, {"genesis": {}, "genesis_ckpt": path}):
        bank, rings = in_process_bank(wksp, device=device, **kw)
        for i, f in enumerate(frames):
            rings["pb"].publish(f, sig=i)
        bank.poll_once()
        bank.poll_once()          # drain-on-idle retires the wave
        out.append({"poh": drain(rings["ph"])[0],
                    "done": drain(rings["dn"])[0],
                    "balances": bank.funk.root_items(),
                    "m": bank.metrics_items()})
    a, b = out
    assert a["m"]["transfers"] > 0
    for key in ("poh", "done", "balances"):
        assert a[key] == b[key], key
    assert a["m"] == b["m"]
    return {"transfers": a["m"]["transfers"], "poh_frames": len(a["poh"]),
            "done_frags": len(a["done"]), "accounts": len(a["balances"]),
            "wave_launches": [o["m"]["wave_launches"] for o in out]}


def byte_identity(wksp, txns, device="cuda") -> dict:
    genesis = synth_genesis()
    frames = microblocks(txns)
    bank_a, rings_a = in_process_bank(wksp, genesis)
    for i, f in enumerate(frames):
        rings_a["pb"].publish(f, sig=i)
    bank_a.poll_once()
    bank_a.poll_once()            # drain-on-idle retires the wave
    bank, execs, rings = family(wksp, n_exec=2, genesis=genesis,
                                device=device)
    for i, f in enumerate(frames):
        rings["pack_bank0"].publish(f, sig=i)
    bank.poll_once()
    assert bank.fanout.wave is not None \
        and bank.fanout.wave["remaining"] >= 1
    for e in execs:
        e.poll_once()
    bank.poll_once()
    assert bank.fanout.wave is None
    assert bank.m["transfers"] == bank_a.m["transfers"] > 0
    assert bank.m["exec_fail"] == bank_a.m["exec_fail"]
    poh, _ = drain(rings["bank0_poh"])
    done, _ = drain(rings["bank0_done"])
    assert poh == drain(rings_a["ph"])[0]     # bytes and sigs, in order
    assert done == drain(rings_a["dn"])[0]
    bal = {k: bank.funk.rec_query(None, bytes.fromhex(k)) for k in genesis}
    for k, v in bal.items():
        assert v == bank_a.funk.rec_query(None, bytes.fromhex(k)), k
    assert all(e.m["txns"] > 0 for e in execs)
    return {"poh": poh, "done": done, "balances": bal,
            "transfers": bank.m["transfers"],
            "shard_txns": [e.m["txns"] for e in execs]}


def conflict_isolation(wksp, device="cuda") -> dict:
    keys = [hashlib.sha256(b"ct%d" % i).digest() for i in range(9)]
    genesis = {k.hex(): 1_000_000 for k in keys}
    bank, execs, rings = family(wksp, n_exec=2, genesis=genesis,
                                device=device)
    # a chain k0 -> k1 -> k2 -> k3 (conflicting, order-sensitive) and
    # the disjoint pairs k4 -> k5, k6 -> k7, k8 -> k8
    txns = [
        SystemTxn(src=keys[0], dst=keys[1], amount=900_000, fee=0),
        SystemTxn(src=keys[1], dst=keys[2], amount=1_800_000, fee=0),
        SystemTxn(src=keys[2], dst=keys[3], amount=2_000_000, fee=0),
        SystemTxn(src=keys[4], dst=keys[5], amount=5, fee=7),
        SystemTxn(src=keys[6], dst=keys[7], amount=11, fee=0),
        SystemTxn(src=keys[8], dst=keys[8], amount=13, fee=0),
    ]
    bank.fanout.dispatch(txns, tag=[])
    per_tile, chain, wire = [], [], []
    for i in range(2):
        accts = set()
        frames, _ = drain(rings[f"exec_disp{i}"])
        wire.append(frames)
        for frame, _sig in frames:
            _ws, _xid, cnt = _EXEC_HDR.unpack_from(frame, 0)
            off = _EXEC_HDR.size
            for _ in range(cnt):
                src, dst = frame[off:off + 32], frame[off + 32:off + 64]
                amt, _fee = _EXEC_TXN.unpack_from(frame, off + 64)
                accts |= {src, dst}
                if src in keys[:4]:
                    chain.append((i, amt))
                off += _EXEC_TXN_SZ
        per_tile.append(accts)
    assert per_tile[0] and per_tile[1]
    assert not per_tile[0] & per_tile[1], "an account in two shards"
    assert len({t for t, _ in chain}) == 1, "the chain split over shards"
    assert [a for _, a in chain] == [900_000, 1_800_000, 2_000_000]
    for e in execs:
        e.poll_once()
    bank.poll_once()
    assert bank.fanout.wave is None
    oracle = {k: 1_000_000 for k in keys}
    execute_block_serial(oracle, txns)
    for k in keys:
        assert bank.funk.rec_query(None, k) == oracle[k]
    return {"wire": wire, "balances": {k.hex(): oracle[k] for k in keys}}


def shard_death(wksp, txns, device="cuda") -> dict:
    genesis = synth_genesis()
    bank, execs, rings = family(wksp, n_exec=2, redispatch_s=30.0,
                                genesis=genesis, device=device)
    frames = microblocks(txns)
    for i, f in enumerate(frames):
        rings["pack_bank0"].publish(f, sig=i)
    bank.poll_once()
    assert bank.fanout.wave is not None
    xid1 = bank.fanout.wave["xid"]
    # shard 0 'dies': nobody drains exec_disp0; shard 1 completes its
    # share and the wave must NOT publish on a partial completion set
    execs[1].poll_once()
    bank.poll_once()
    assert bank.fanout.wave is not None and bank.fanout.wave["xid"] == xid1
    root = {k: bank.funk.rec_query(None, bytes.fromhex(k)) for k in genesis}
    assert root == genesis, "a mid-wave write is visible at the root"
    # the deadline (forced: no wall-clock flake) cancels and redispatches
    bank.fanout.wave["deadline"] = time.monotonic() - 1
    bank.poll_once()
    assert bank.m["exec_redispatch"] == 1
    assert bank.fanout.wave is not None and bank.fanout.wave["xid"] != xid1
    assert not bank.funk.txn_is_prepared(xid1)
    # 'restart': fresh adapters from seq 0 see the stale frames first
    # (cancelled fork: abandoned, no completion), then the fresh ones
    restarted = [ExecAdapter(exec_ctx(wksp, execs[i].ctx.plan, rings, i,
                                      f"exec{i}r"),
                             {"batch": 16, "device": device})
                 for i in range(2)]
    for e in restarted:
        e.poll_once()
    stale = sum(e.m["stale_xid"] for e in restarted)
    assert stale >= 1, "no cancelled-fork frame was abandoned"
    deadline = time.monotonic() + 10
    while bank.fanout.wave is not None and time.monotonic() < deadline:
        bank.poll_once()
    assert bank.fanout.wave is None, "the bank wedged"
    assert bank.m["exec_redispatch"] == 1
    all_t = []
    for f in frames:
        t, _ = bank._parse_transfers(f, struct.unpack_from("<HHQQ", f)[1])
        all_t.extend(t)
    oracle = {bytes.fromhex(k): v for k, v in genesis.items()}
    execute_block_serial(oracle, all_t)
    for k, v in oracle.items():
        assert bank.funk.rec_query(None, k) == v, "not exactly once"
    assert rings["bank0_done"].seq == rings["bank0_poh"].seq == len(frames)
    return {"exec_redispatch": bank.m["exec_redispatch"],
            "stale_xid": stale, "xid1": xid1,
            "balances": {k.hex(): v for k, v in oracle.items()},
            "done": drain(rings["bank0_done"])[0],
            "poh": drain(rings["bank0_poh"])[0]}


# -- the follower's fan-out -------------------------------------------------

def inline_oracle(genesis: dict):
    """ReplayCore over InlineFanout on an in-process funk, on the CPU."""
    from ..funk.funk import Funk
    from ..tiles.replay import InlineFanout, ReplayCore
    funk = Funk()
    return ReplayCore(genesis=genesis, verify_poh=False, funk=funk,
                      fanout=InlineFanout(funk, "cpu"), device="cpu")


def follower(wksp, n_exec: int = 2, redispatch_s: float = 5.0,
             expected=None, device="cuda", **core_kw):
    """ReplayCore over a real ExecFanout and n_exec ExecAdapters. ->
    (core, execs, rings, funk)."""
    from ..tiles.replay import ReplayCore
    funk_plan = store_plan(wksp)
    links = {}
    for i in range(n_exec):
        links[f"exec_disp{i}"] = {"mtu": 4096}
        links[f"exec_done{i}"] = {"mtu": 64}
    rings = {ln: Ring.create(wksp, depth=64, mtu=li["mtu"])
             for ln, li in links.items()}
    plan = {"links": links, "funk": funk_plan}
    funk = WireFunk.from_plan(wksp, funk_plan)
    disp = [f"exec_disp{i}" for i in range(n_exec)]
    done = [f"exec_done{i}" for i in range(n_exec)]
    ctx = SimpleNamespace(
        tile_name="replay", plan=plan, wksp=wksp,
        in_rings={ln: rings[ln] for ln in done},
        out_rings={ln: rings[ln] for ln in disp},
        out_fseqs={ln: [] for ln in disp}, in_seq0={})
    fanout = ExecFanout(ctx, funk, disp, done,
                        m={"exec_waves": 0, "exec_redispatch": 0,
                           "overruns": 0},
                        redispatch_s=redispatch_s)
    core = ReplayCore(funk=funk, fanout=fanout, verify_poh=False,
                      expected=expected or {}, device=device, **core_kw)
    fanout.m = core.metrics
    execs = [ExecAdapter(exec_ctx(wksp, plan, rings, i),
                         {"batch": 8, "device": device})
             for i in range(n_exec)]
    return core, execs, rings, funk


class ShardThreads:
    """Poll exec adapters from threads: ReplayCore._execute_fanout spins
    each wave to completion on the caller's thread, so the shards must
    progress beside it (in a topology they are processes)."""

    def __init__(self):
        self.stop = threading.Event()
        self.threads = []
        self.errors = []

    def run(self, adapter, delay_s: float = 0.0):
        def loop():
            try:
                if delay_s:
                    time.sleep(delay_s)
                while not self.stop.is_set():
                    if not adapter.poll_once():
                        time.sleep(1e-4)
            except BaseException as e:    # noqa: BLE001 — join reraises
                self.errors.append(e)
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self.threads.append(t)

    def join(self, timeout_s: float = 30.0):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=timeout_s)
        if self.errors:
            raise self.errors[0]


def replay_fanout(wksp, txns, n_slots: int, device="cuda",
                  dead_shard_s: float = 0.0,
                  redispatch_s: float = 5.0) -> dict:
    """Replay `n_slots` slots of `txns` through ReplayCore over ExecFanout
    and two shards, against ReplayCore over InlineFanout on the CPU (the
    plain wave scan and lthash, so a wrong kernel cannot agree with
    itself); with
    `dead_shard_s`, shard 0 starts that late (a redispatch before it
    rejoins). -> the per-slot bank hashes, the fan-out's counts and the
    wave-scan launches the shards made (the oracle's are not counted)."""
    genesis = {bytes.fromhex(k): v for k, v in synth_genesis(8).items()}
    slices = slot_slices(split(txns, n_slots), b"fo-tip-")
    oracle = inline_oracle(genesis)
    for s in range(1, n_slots + 1):
        oracle.on_slice(slices[s])
    expected = {s: oracle.bank_hash_of[s] for s in range(1, n_slots + 1)}
    core, execs, rings, funk = follower(
        wksp, n_exec=2, redispatch_s=redispatch_s, expected=expected,
        device=device, genesis=genesis)
    n0 = cuda_wave.launches["wave_scan"]
    shards = ShardThreads()
    shards.run(execs[1])
    shards.run(execs[0], delay_s=dead_shard_s)
    t0 = time.perf_counter()
    try:
        for s in range(1, n_slots + 1):
            core.on_slice(slices[s])
    finally:
        shards.join()
    wall = time.perf_counter() - t0
    launches = cuda_wave.launches["wave_scan"] - n0
    got = {s: core.bank_hash_of[s] for s in range(1, n_slots + 1)}
    assert got == expected, "a slot's bank hash != InlineFanout's"
    assert core.metrics["slots_replayed"] == n_slots
    assert core.metrics["divergent_slot"] == 0
    bal = dict(genesis)
    transfers, _ = core._extract_transfers(txns[:n_slots * max(
        1, len(txns) // n_slots)])
    execute_block_serial(bal, transfers)
    for pk, want in bal.items():
        rec = funk.rec_query(None, pk)
        assert getattr(rec, "lamports", rec) == want, "not exactly once"
    return {"bank_hashes": got, "wall_s": wall,
            "exec_waves": core.metrics["exec_waves"],
            "exec_redispatch": core.metrics["exec_redispatch"],
            "stale_xid": sum(e.m["stale_xid"] for e in execs),
            "shard_txns": [e.m["txns"] for e in execs],
            "shard_frames": [e.m["frames"] for e in execs],
            "launches": launches}
