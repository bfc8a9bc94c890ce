"""bench.py's exec-scale stage on the port: the leader loop with execution
scaled out of the bank (`_exec_leader_topology`, bench.py:698-783, less
core pinning) and one unpaced capacity boot of it per exec tile count
(`_exec_scale_bench`, bench.py:786-855), used by chip_smoke.py phase 20b.

    synth -> verify x2 -> dedup -> resolv -> pack (resolved_in) -> bank0
    bank0 -> exec_disp{i} -> exec{i} -> exec_done{i} -> bank0, i < N
    bank0 -> poh -> shred <-> sign -> shredsink

Every tile of the loop shares the shm account store ([funk] backend
"shm"); pack reads bank0_done and poh_slots unreliably and the bank its
exec_done links, as in bench.py: a reliable edge there closes a credit
cycle. bench.py pins the verify shards to `cpu0 + i` only when the host
has `verify_tiles + exec_cnt + 7` cores; on a host of eight it gives
`cpu0 = None` at every N, which is this topology (it never pins; a
sharded tile takes `cpu0` where a caller wants the rule).

`run_exec_scale` times one boot as bench.py does: from every tile at
RUN until every synth frame is accounted for (tools/leader_drain.py's
conservation rule with the resolv tile's drops) and pack has retired
every microblock, then halts at once (the shred tile's Reed-Solomon
backlog is not waited out) and holds the run's counts exact: bank txns
plus the counted drops equal the count, pack's completions equal its
microblocks, the exec shards' txns sum to the transfers the bank
committed, no stale fork and no redispatch, a launch in every shard,
the store's lamports equal genesis's less the fees burned, every
account in the store equals the plain serial executor's balance over
the frames synth sent (`serial_balances`: a valid frame repeats only
after `unique` others, past the dedup window, so the bank executes
every one), and no verify tile fell back or saw a device error.
"""
from __future__ import annotations

import functools
import os
import time

LEADER_TILES = ("synth", "dedup", "pack", "bank0", "poh", "shred",
                "shredsink")
LEADER_LINKS = ("ingest", "dedup_pack", "pack_bank0", "bank0_poh",
                "poh_entries", "shreds_mirror")
IDENTITY_HEX = ("03a107bff3ce10be1d70dd18e74bc09967e4d6309ba50d5f1ddc86641"
                "25531b8")
SIGN_SEED_HEX = ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b"
                 "1c1d1e1f")
VERIFY_TILES = 2
VERIFY_BATCH = 32
SYNTH_SEED = 17
TIMEOUT_S = 300.0                 # each of the boot and the drain


def exec_leader_topology(count: int, unique: int, exec_cnt: int,
                         device="cuda"):
    """bench.py's `_exec_leader_topology` on the port's Topology at
    bench.py's own verify batch, verify tile count, unpaced rate and
    tcache depth, with `device` on the verify, bank and exec tiles and
    no core pinning."""
    from ..disco import Topology
    tcache_depth = max(16, 1 << (max(64, int(unique)).bit_length() - 4))
    vd = [f"vd{i}" for i in range(VERIFY_TILES)]
    disp = [f"exec_disp{i}" for i in range(exec_cnt)]
    done = [f"exec_done{i}" for i in range(exec_cnt)]
    topo = (
        Topology(f"exs{exec_cnt}{os.getpid()}", wksp_size=1 << 27,
                 funk={"backend": "shm", "heap_mb": 16})
        .link("ingest", depth=4096, mtu=1280)
        .link("dedup_resolv", depth=4096, mtu=1280)
        .link("resolv_pack", depth=4096, mtu=2048)
        .link("pack_bank0", depth=256, mtu=16384)
        .link("bank0_done", depth=256, mtu=64)
        .link("bank0_poh", depth=256, mtu=16448)
        .link("poh_entries", depth=512, mtu=16640)
        .link("poh_slots", depth=64, mtu=64)
        .link("shreds_mirror", depth=4096, mtu=1280)
        .link("shred_req", depth=32, mtu=1280)
        .link("sign_resp", depth=32, mtu=128)
        .tcache("dedup_tc", depth=tcache_depth)
        .tile("synth", "synth", outs=["ingest"], count=count,
              unique=unique, burst=512, seed=SYNTH_SEED, rate_tps=0.0)
        .tile("dedup", "dedup", ins=vd, outs=["dedup_resolv"],
              tcache="dedup_tc", batch=1024)
        .tile("resolv", "resolv", ins=["dedup_resolv"],
              outs=["resolv_pack"], batch=256, fee_payer_check=False)
        .tile("pack", "pack",
              ins=["resolv_pack", ("bank0_done", False),
                   ("poh_slots", False)],
              outs=["pack_bank0"], txn_in="resolv_pack",
              resolved_in=True, bank_links=["pack_bank0"],
              done_links=["bank0_done"], slot_in="poh_slots",
              max_txn_per_microblock=31, wave=4, batch=256)
        .tile("bank0", "bank",
              ins=["pack_bank0"] + [(ln, False) for ln in done],
              outs=["bank0_done", "bank0_poh"] + disp,
              exec="svm", wave=8, poh_link="bank0_poh",
              forward_payloads=True, genesis_synth=unique,
              exec_links=disp, exec_done=done, device=device)
        .tile("poh", "poh", ins=["bank0_poh"],
              outs=["poh_entries", "poh_slots"],
              slot_link="poh_slots", hashes_per_tick=64,
              ticks_per_slot=8)
        .tile("shred", "shred", mode="leader",
              ins=["poh_entries", ("sign_resp", False)],
              outs=["shred_req", "shreds_mirror"], req="shred_req",
              resp="sign_resp", shreds_link="shreds_mirror",
              identity_hex=IDENTITY_HEX,
              cluster=[{"pubkey_hex": "55" * 32, "stake": 100,
                        "addr": "127.0.0.1:9"}])
        .tile("sign", "sign", ins=[("shred_req", False)],
              outs=["sign_resp"], seed=SIGN_SEED_HEX,
              clients=[{"role": "leader", "req": "shred_req",
                        "resp": "sign_resp"}])
        .tile("shredsink", "sink", ins=["shreds_mirror"]))
    for ln in disp:
        topo.link(ln, depth=64, mtu=4096)
    for ln in done:
        topo.link(ln, depth=64, mtu=64)
    for i in range(VERIFY_TILES):
        topo.link(vd[i], depth=4096, mtu=1280)
        topo.tcache(f"vtc{i}", depth=tcache_depth)
    topo.sharded_tile(
        "verify", "verify", VERIFY_TILES, ins=["ingest"], outs=vd,
        batch=VERIFY_BATCH, coalesce_us=500, device=device,
        tcache=[f"vtc{i}" for i in range(VERIFY_TILES)])
    topo.sharded_tile("exec", "exec", exec_cnt, ins=[disp], outs=done,
                      batch=8, device=device)
    return topo


def hop_snapshot(runner, tiles_extra=()) -> dict:
    """bench.py's `_leader_hop_snapshot`: cumulative per-tile work and
    wait sums and per-link backpressure."""
    from ..disco.metrics import read_hists, read_link_metrics
    tiles = {}
    for t in list(LEADER_TILES) + [f"verify{i}" for i in
                                   range(VERIFY_TILES)] + list(tiles_extra):
        h = read_hists(runner.wksp, runner.plan, t)
        tiles[t] = (h["work"]["sum_ns"], h["wait"]["sum_ns"])
    links = {ln: rec["backpressure"]
             for ln, rec in read_link_metrics(runner.wksp,
                                              runner.plan).items()}
    return {"tiles": tiles, "links": links}


def hop(prev: dict, cur: dict, links_extra=()):
    """bench.py's `_leader_hop`: (the top-occupancy tile, the first link
    showing fresh backpressure) between two snapshots."""
    occ = {}
    for t, (w1, i1) in cur["tiles"].items():
        w0, i0 = prev["tiles"].get(t, (0, 0))
        dw, di = w1 - w0, i1 - i0
        occ[t] = dw / (dw + di) if dw + di else 0.0
    top = max(occ, key=occ.get) if occ else None
    order = ["ingest"] + [f"vd{i}" for i in range(VERIFY_TILES)] \
        + [ln for ln in LEADER_LINKS if ln != "ingest"] + list(links_extra)
    bp = next((ln for ln in order
               if cur["links"].get(ln, 0) - prev["links"].get(ln, 0) > 0),
              None)
    return top, bp, occ


def store_balances(runner) -> dict:
    """Every record's lamports at the shm store's root, by key."""
    from ..funk.shmfunk import WireFunk
    funk = WireFunk.from_plan(runner.wksp, runner.plan["funk"])
    return {k: getattr(v, "lamports", v)
            for k, v in funk.root_items().items()}


def store_lamports(runner) -> int:
    """The lamports of every record at the shm store's root."""
    return sum(store_balances(runner).values())


@functools.cache
def serial_balances(count: int, unique: int) -> dict:
    """The plain path's balances after synth's `count` frames (frame j
    is its pool's txn j % unique) on `_synth_genesis(unique)`:
    svm/executor.py's `execute_block_serial` over the transfers parsed
    from the frames, each charged one signature fee; every one must
    succeed, so the order the bank ran them in does not matter. The
    signatures are left zero: they change no balance. Read only: the
    dict is cached."""
    from ..disco.tiles import _synth_genesis
    from ..pack.scheduler import FEE_PER_SIGNATURE
    from ..protocol.txn import parse_txn
    from ..svm.executor import STATUS_OK, SystemTxn, execute_block_serial
    from ..tiles.synth import make_signed_txns
    from ..utils.ed25519_ref import keypair
    pubs = {}

    def signer(seed, msg):
        if seed not in pubs:
            pubs[seed] = keypair(seed)[-1]
        return pubs[seed], bytes(64)

    pool = []
    for raw in make_signed_txns(min(count, unique), seed=SYNTH_SEED,
                                signer=signer):
        t = parse_txn(raw)
        keys, (ins,) = t.account_keys(raw), t.instrs
        data = raw[ins.data_off:ins.data_off + ins.data_sz]
        pool.append(SystemTxn(
            src=keys[ins.acct_idxs[0]], dst=keys[ins.acct_idxs[1]],
            amount=int.from_bytes(data[4:12], "little"),
            fee=FEE_PER_SIGNATURE * t.sig_cnt))
    bal = dict(_synth_genesis(unique))
    status = execute_block_serial(
        bal, [pool[j % len(pool)] for j in range(count)])
    assert all(st == STATUS_OK for st in status), "a serial transfer failed"
    return bal


def run_exec_scale(exec_cnt: int, count: int = 4096, unique: int = 768,
                   device="cuda") -> dict:
    """One unpaced capacity boot of the loop at `exec_cnt` shards.
    -> its record; raises AssertionError when a count is off."""
    from ..disco import TopologyRunner
    from ..pack.scheduler import FEE_PER_SIGNATURE
    from . import leader_drain
    from ..disco.tiles import _synth_genesis
    execs = [f"exec{i}" for i in range(exec_cnt)]
    tiles_extra = ["resolv"] + execs
    links_extra = ["dedup_resolv", "resolv_pack"] \
        + [f"exec_disp{i}" for i in range(exec_cnt)] \
        + [f"exec_done{i}" for i in range(exec_cnt)]
    runner = TopologyRunner(exec_leader_topology(
        count, unique, exec_cnt, device=device).build())
    t_boot = time.perf_counter()
    runner.start()
    try:
        runner.wait_running(timeout_s=TIMEOUT_S)
        boot_s = time.perf_counter() - t_boot
        snap0 = hop_snapshot(runner, tiles_extra)
        t0 = time.perf_counter()
        runner.wait_idle("synth", "tx", count, timeout_s=TIMEOUT_S,
                         poll_s=0.002)
        dropped = leader_drain.wait_drained(runner, count,
                                            timeout_s=TIMEOUT_S)
        wall = time.perf_counter() - t0
        snap1 = hop_snapshot(runner, tiles_extra)
        t1 = time.perf_counter()
        runner.halt()
        halt_s = time.perf_counter() - t1
        m = {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}
        b, p = m["bank0"], m["pack"]
        top, bp, occ = hop(snap0, snap1, links_extra)
        genesis = sum(_synth_genesis(unique).values())
        burned = FEE_PER_SIGNATURE * b["transfers"]
        balances = store_balances(runner)
        lamports = sum(balances.values())
        shard_txns = sum(m[e]["txns"] for e in execs)
        for key, got, want in (
                ("bank0.txns + drops", b["txns"] + dropped, count),
                ("pack.completions", p["completions"], p["microblocks"]),
                ("exec txns", shard_txns, b["transfers"] + b["exec_fail"]),
                ("bank0.transfers", b["transfers"], b["txns"]
                 - b["exec_skip"]),
                ("bank0.exec_fail", b["exec_fail"], 0),
                ("bank0.exec_redispatch", b["exec_redispatch"], 0),
                ("exec stale_xid", sum(m[e]["stale_xid"] for e in execs),
                 0),
                ("store lamports", lamports, genesis - burned)):
            assert got == want, f"{exec_cnt} shards: {key} = {got}, " \
                f"expected {want}"
        want = serial_balances(count, unique)
        off = [k.hex() for k in want.keys() | balances.keys()
               if balances.get(k) != want.get(k)]
        assert not off, f"{exec_cnt} shards: {len(off)} accounts differ " \
            f"from execute_block_serial's, e.g. {off[:3]}"
        for e in execs:
            assert m[e]["wave_launches"] >= 1 or device == "cpu", \
                f"{e} launched no wave scan: {m[e]}"
        for i in range(VERIFY_TILES):
            v = m[f"verify{i}"]
            assert v["cpu_fallback"] == 0 and v["device_errors"] == 0, \
                f"verify{i}: {v}"
        return {
            "exec_cnt": exec_cnt, "exec_scale_tps": b["txns"] / wall,
            "txns": b["txns"], "wall_s": wall, "boot_s": boot_s,
            "halt_s": halt_s, "dropped": dropped,
            "top_occupancy_tile": top, "first_backpressured_link": bp,
            "occupancy": occ,
            "exec_txns": {e: m[e]["txns"] for e in execs},
            "exec_frames": {e: m[e]["frames"] for e in execs},
            "wave_launches": {e: m[e]["wave_launches"] for e in execs},
            "bank_exec_waves": b["exec_waves"],
            "bank_exec_redispatch": b["exec_redispatch"],
            "bank_microblocks": b["microblocks"],
            "transfers": b["transfers"], "fees_burned": burned,
            "store_lamports": lamports,
            "verify_batches": {f"verify{i}": m[f"verify{i}"]["batches"]
                               for i in range(VERIFY_TILES)}}
    finally:
        runner.halt()
        runner.close()
