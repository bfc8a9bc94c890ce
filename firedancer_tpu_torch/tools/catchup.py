"""bench.py's catch-up stage on the port (`_catchup_fixture`, bench.py:846;
`_follower_topology`, :898; `_catchup_bench`, :934) and the cold-start
follower's drills, used by chip_smoke.py phase 22 and
tests/test_torch_catchup.py.

    snapld -> snap_stream -> snapin        (restores the shm store, then
                                            writes the restore marker)
    playback -> shred_slices -> replay     (wait_restore, the leader's
                                            bank hashes pinned)
    replay -> exec_disp{i} -> exec{i} -> exec_done{i} -> replay, i < N
    replay -> replay_tower -> towersink

`catchup_fixture` is the leader-side oracle: it replays the slots on the
CPU (ReplayCore over InlineFanout, device "cpu"), writes the v2
snapshot at the snapshot slot and archives the tail slices for playback;
what it returns pickles, so a caller may build it in a worker process
while the card does other work. `run_catchup` boots the follower (on a
fixture it builds, or one it is given) and times it as bench.py does (from
every tile at RUN until the replay has replayed the tail), then holds
the run to the oracle: the restore slot, no divergent slot, every
replayed slot's bank hash (the tower frames) and every account of the
shm store equal to the oracle's, a wave-scan launch in every exec shard
and an lthash launch in the replay on the card. `accounts` widens the
snapshot to that many funded accounts: bench.py's 16 signers plus
system accounts from `seed` (a real state size; the store and workspace
are sized to hold it).

The drills: `snapshot_drills` (corrupt_checkpt_frame and
stale_snapshot_offer through snapld's and snapin's adapters on
in-process rings over a carved store: refused, the store untouched),
`snapld_crash_drill` (crash_mid_snapshot on a supervised snapld: the
restart re-streams from byte 0 and the restore completes),
`writer_crash_drill` (crash_mid_snapshot on the replay's snapshot
writer, in a spawned process: the previous file intact and restorable,
the half-written .tmp refused) and `archive_restore` (the real archive
format through SnapLoader -> SnapDecompress -> ArchiveInserter, its
lattice checked on `device`).

    python -m firedancer_tpu_torch.tools.catchup [--device cpu]
        [--accounts N]          bench.py's stage; prints its keys as one
                                JSON line
    python -m firedancer_tpu_torch.tools.catchup --write [DIR]
                                writes the fixture cfg/catchup.toml boots
                                (default DIR: FIXTURE_DIR)
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import struct
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from .slices import slot_slices, split

# bench.py's defaults (FDTPU_BENCH_CATCHUP_*, bench.py:946-953)
COUNT = 192
UNIQUE = 16
SLOTS = 12
SNAP_SLOT = 4
EXEC_TILES = 2
TXN_SEED = 23
TIMEOUT_S = 600.0               # each of the boot and the catch-up
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where `--write` puts the fixture cfg/catchup.toml names (the build
# directory is not committed)
FIXTURE_DIR = os.path.join(ROOT, "firedancer_tpu_torch", "build", "catchup")


def funded_accounts(n: int, unique: int = UNIQUE, seed: int = 0) -> dict:
    """{pubkey: lamports}: bench.py's genesis (the first `unique` synth
    signers) and n - unique system accounts with keys and balances
    drawn from `seed`."""
    from ..disco.tiles import _synth_genesis
    gen = _synth_genesis(unique)
    extra = max(0, n - len(gen))
    rng = np.random.default_rng(seed)
    keys = rng.bytes(32 * extra)
    lam = rng.integers(1, 1 << 40, extra)
    for i in range(extra):
        gen[keys[32 * i:32 * i + 32]] = int(lam[i])
    return gen


def fixture_slices(count: int, n_slots: int) -> dict:
    """slot -> one complete slice of bench.py's fixture: one entry of the
    slot's share of `make_signed_txns(count, seed=23)` behind a
    hand-built tip (PoH verify is off in the stage)."""
    from ..tiles.synth import make_signed_txns
    return slot_slices(split(make_signed_txns(count, seed=TXN_SEED),
                             n_slots), b"cu-tip-")


def catchup_fixture(tmp: str, count: int = COUNT, unique: int = UNIQUE,
                    n_slots: int = SLOTS, snap_slot: int = SNAP_SLOT,
                    accounts: int = 0, seed: int = 0) -> dict:
    """bench.py's `_catchup_fixture` with the oracle on the CPU: replay
    the slots in process, write the v2 snapshot at `snap_slot` (atomic,
    with slot + bank hash meta) to tmp/snap.ckpt, archive the tail
    slices for playback in tmp/tail.arch. -> {"snap", "tail": the
    paths, "expected": {str slot: bank hash hex} of the tail,
    "bank_hashes": the same for every slot, "txns": the oracle's txns,
    "accounts": its store root {key: value}, "snap_slot", "n_slots",
    "seconds": the time it took}."""
    t0 = time.perf_counter()
    from ..disco.tiles import _synth_genesis
    from ..funk.funk import Funk
    from ..tiles.replay import InlineFanout, ReplayCore
    from ..utils.checkpt import CheckptWriter, snapshot_write_atomic
    gen = funded_accounts(accounts, unique, seed) if accounts \
        else _synth_genesis(unique)
    funk = Funk()
    oracle = ReplayCore(genesis=gen, verify_poh=False, funk=funk,
                        fanout=InlineFanout(funk, device="cpu"),
                        device="cpu")
    slices = fixture_slices(count, n_slots)
    snap_path = os.path.join(tmp, "snap.ckpt")
    for s in range(1, n_slots + 1):
        oracle.on_slice(slices[s])
        if s == snap_slot:
            snapshot_write_atomic(snap_path, oracle.funk, slot=s,
                                  bank_hash=oracle.bank_hash_of[s])
    tail_path = os.path.join(tmp, "tail.arch")
    with open(tail_path, "wb") as fp:
        w = CheckptWriter(fp, compress=True)
        for i, s in enumerate(range(snap_slot + 1, n_slots + 1)):
            payload = slices[s]
            w.frame(struct.pack("<QQHI", i, s, 0, len(payload)) + payload)
        w.fini()
    hashes = {str(s): oracle.bank_hash_of[s].hex()
              for s in range(1, n_slots + 1)}
    return {"snap": snap_path, "tail": tail_path, "bank_hashes": hashes,
            "expected": {str(s): hashes[str(s)]
                         for s in range(snap_slot + 1, n_slots + 1)},
            "txns": oracle.metrics["txns"],
            "accounts": oracle.funk.root_items(), "snap_slot": snap_slot,
            "n_slots": n_slots, "seconds": time.perf_counter() - t0}


def funk_section(accounts: int = 0) -> dict:
    """The [funk] section: bench.py's (16 MiB heap, the default record
    slots) or one that holds `accounts` records at half load."""
    if not accounts:
        return {"backend": "shm", "heap_mb": 16}
    return {"backend": "shm", "rec_max": 1 << (2 * accounts).bit_length(),
            "heap_mb": max(16, accounts >> 12)}


def wksp_size(funk: dict) -> int:
    """bench.py's 64 MiB, or room for the store of a wider [funk]."""
    from ..funk.shmfunk import normalize_funk
    from ..runtime import Store
    f = normalize_funk(funk)
    return max(1 << 26, Store.footprint(
        f["rec_max"], f["txn_max"], f["heap_mb"] << 20) + (1 << 26))


def follower_topology(snap_path: str, tail_path: str, expected: dict,
                      snap_slot: int, exec_cnt: int, device="cuda",
                      accounts: int = 0, name: str | None = None):
    """bench.py's `_follower_topology` on the port's Topology, with
    `device` on the replay and exec tiles: snapld -> snapin restoring
    the shm store while playback floods the slice tail at full speed;
    the replay tile buffers behind the restore gate, then catches up
    over `exec_cnt` exec shards with the leader's bank hashes pinned."""
    from ..disco import Topology
    disp = [f"exec_disp{i}" for i in range(exec_cnt)]
    done = [f"exec_done{i}" for i in range(exec_cnt)]
    funk = funk_section(accounts)
    topo = (
        Topology(name or f"cu{os.getpid()}", wksp_size=wksp_size(funk),
                 funk=funk,
                 snapshot={"path": snap_path, "min_slot": snap_slot,
                           "chunk": 4096})
        .link("snap_stream", depth=256, mtu=1 << 16)
        .link("shred_slices", depth=256, mtu=1 << 16)
        .link("replay_tower", depth=128, mtu=128)
        .tile("snapld", "snapld", outs=["snap_stream"])
        .tile("snapin", "snapin", ins=["snap_stream"])
        .tile("playback", "playback", outs=["shred_slices"],
              path=tail_path)
        .tile("replay", "replay",
              ins=["shred_slices"] + [(ln, False) for ln in done],
              outs=["replay_tower"] + disp,
              exec_links=disp, exec_done=done, wait_restore=True,
              expected=expected, verify_poh=False, device=device)
        .tile("towersink", "sink", ins=["replay_tower"]))
    for ln in disp:
        topo.link(ln, depth=64, mtu=4096)
    for ln in done:
        topo.link(ln, depth=64, mtu=64)
    topo.sharded_tile("exec", "exec", exec_cnt, ins=[disp], outs=done,
                      batch=8, device=device)
    return topo


def store_root(wksp, plan_funk: dict) -> dict:
    """Every record at the shm store's root but the restore marker."""
    from ..funk.shmfunk import WireFunk
    from ..utils.checkpt import RESTORE_MARKER_KEY
    items = WireFunk.from_plan(wksp, plan_funk).root_items()
    items.pop(RESTORE_MARKER_KEY, None)
    return items


def run_catchup(exec_cnt: int = EXEC_TILES, device="cuda",
                accounts: int = 0, seed: int = 0,
                fixture: dict | None = None) -> dict:
    """bench.py's `_catchup_bench` with its keys, held to the oracle: on
    `fixture` (catchup_fixture's; built here at bench.py's defaults,
    with `accounts` and `seed`, when None; `accounts` also sizes the
    store). -> the record; raises
    AssertionError when the follower disagrees with the oracle and
    RuntimeError when it never catches up."""
    from ..disco import TopologyRunner
    from ..tiles.tower import parse_block
    from .leader_drain import link_frames
    tmp = tempfile.mkdtemp(prefix="fdtt_catchup_")
    try:
        fx = fixture or catchup_fixture(tmp, accounts=accounts, seed=seed)
        expected, snap_slot = fx["expected"], fx["snap_slot"]
        target = fx["n_slots"] - snap_slot
        runner = TopologyRunner(follower_topology(
            fx["snap"], fx["tail"], expected, snap_slot, exec_cnt,
            device=device, accounts=accounts).build())
        out = {"catchup_slots": target, "catchup_count": fx["txns"]}
        t_boot = time.perf_counter()
        runner.start()
        try:
            runner.wait_running(timeout_s=TIMEOUT_S)
            t0 = time.perf_counter()
            boot_s = t0 - t_boot
            deadline = t0 + TIMEOUT_S
            m = {}
            while time.perf_counter() < deadline:
                runner.check_failures()
                m = runner.metrics("replay")
                if m.get("slots_replayed", 0) >= target:
                    break
                time.sleep(0.002)
            wall = time.perf_counter() - t0
            if m.get("slots_replayed", 0) < target:
                raise RuntimeError(
                    f"follower never caught up: "
                    f"{m.get('slots_replayed', 0)}/{target} slots in "
                    f"{wall:.1f}s (divergent_slot="
                    f"{m.get('divergent_slot', 0)})")
            out["catchup_s"] = wall
            out["replay_tps"] = m["txns"] / wall if wall else 0.0
            out["catchup_restore_slot"] = m.get("restore_slot", 0)
            out["catchup_divergent_slot"] = m.get("divergent_slot", 0)
            out["catchup_exec_waves"] = m.get("exec_waves", 0)
            tower = {}
            for f in link_frames(runner, "replay_tower"):
                slot, _, bank_hash, _ = parse_block(f)
                tower[str(slot)] = bank_hash.hex()
            store = store_root(runner.wksp, runner.plan["funk"])
            mt = {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}
        finally:
            runner.halt()
            runner.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sn, rp = mt["snapin"], mt["replay"]
    execs = [f"exec{i}" for i in range(exec_cnt)]
    assert out["catchup_restore_slot"] == snap_slot, out
    assert out["catchup_divergent_slot"] == 0, out
    assert sn["restored"] == 1 and sn["slot"] == snap_slot \
        and sn["stream_err"] == 0, sn
    assert tower == expected, "a replayed bank hash != the oracle's"
    want = fx["accounts"]
    off = [k.hex() for k in want.keys() | store.keys()
           if store.get(k) != want.get(k)]
    assert not off, f"{len(off)} store accounts differ from the oracle's, " \
        f"e.g. {off[:3]}"
    if device != "cpu":
        for e in execs:
            assert mt[e]["wave_launches"] >= 1, f"{e}: {mt[e]}"
        assert rp["lthash_launches"] >= 1, rp
    for tn, tm in mt.items():
        assert tm.get("cpu_fallback", 0) == 0, (tn, tm)
    out.update({
        "accounts": len(store), "fixture_s": fx["seconds"],
        "boot_s": boot_s,
        "txns": rp["txns"], "snapin_restore_s": sn["restore_us"] / 1e6,
        "gate_read_s": rp["restore_read_us"] / 1e6,
        "gate_fold_s": rp["restore_fold_us"] / 1e6,
        "gate_s": rp["restore_gate_us"] / 1e6,
        "snapshot_bytes": sn["bytes"],
        "wave_launches": {e: mt[e]["wave_launches"] for e in execs},
        "exec_txns": {e: mt[e]["txns"] for e in execs},
        "lthash_launches": rp["lthash_launches"],
        "bank_hashes": len(tower)})
    return out


# -- drills -----------------------------------------------------------------

def stale_snapshot(fx: dict, path: str, slot: int) -> str:
    """The fixture's final accounts as a snapshot of an older `slot`: the
    stale offer snapin's min_slot gate must refuse."""
    from ..funk.funk import Funk
    from ..utils.checkpt import snapshot_write_atomic
    funk = Funk()
    for k, v in fx["accounts"].items():
        funk.rec_write(None, k, v)
    return snapshot_write_atomic(path, funk, slot=slot, bank_hash=bytes(32))


def _snap_pair(wksp, snap_path: str, stale_path: str, min_slot: int):
    """snapld's and snapin's adapters on one in-process ring, snapin over
    a freshly carved store. -> (loader, inserter, plan funk)."""
    from ..disco.tiles import SnapInAdapter, SnapLdAdapter
    from ..runtime import Ring
    from .exec_drills import store_plan
    ring = Ring.create(wksp, depth=64, mtu=4096)
    links = {"snap": {"mtu": 4096}}
    plan = {"links": links, "funk": store_plan(wksp)}
    ld = SnapLdAdapter(SimpleNamespace(
        tile_name="snapld", plan=plan, wksp=wksp, in_rings={},
        out_rings={"snap": ring}, out_fseqs={"snap": []}, in_seq0={}),
        {"path": snap_path, "chunk": 4096, "stale_path": stale_path})
    sn = SnapInAdapter(SimpleNamespace(
        tile_name="snapin", plan=plan, wksp=wksp, in_rings={"snap": ring},
        out_rings={}, out_fseqs={}, in_seq0={}), {"min_slot": min_slot})
    return ld, sn, plan["funk"]


def _stream(ld, sn, max_polls: int = 100_000):
    for _ in range(max_polls):
        ld.poll_once()
        sn.poll_once()
        if ld.tile.metrics["done"] and not sn.poll_once():
            return
    raise RuntimeError("the snapshot stream never ended")


def snapshot_drills(wksp, snap_path: str, stale_path: str,
                    snap_slot: int) -> dict:
    """corrupt_checkpt_frame and stale_snapshot_offer through the
    adapters' chaos hooks, each on its own store: snapin raises
    CheckptError and the store holds no record and no restore marker;
    then the clean stream restores and installs the marker."""
    from ..utils.checkpt import RESTORE_MARKER_KEY, CheckptError
    out = {}
    for action in ("corrupt_checkpt_frame", "stale_snapshot_offer"):
        ld, sn, fk = _snap_pair(wksp, snap_path, stale_path, snap_slot)
        ld.on_chaos({"action": action, "seed": 5})
        try:
            _stream(ld, sn)
        except CheckptError as e:
            err = str(e)
        else:
            raise AssertionError(f"{action}: snapin installed the stream")
        left = store_root(wksp, fk)
        assert not left, f"{action}: {len(left)} records installed"
        from ..funk.shmfunk import WireFunk
        assert WireFunk.from_plan(wksp, fk).rec_query(
            None, RESTORE_MARKER_KEY) is None, action
        out[action] = {"error": err, "loader": ld.metrics_items(),
                       "restored": sn.metrics_items()["restored"]}
    assert out["corrupt_checkpt_frame"]["loader"]["corrupted"] == 1
    assert out["stale_snapshot_offer"]["loader"]["offers"] == 2
    assert "stale snapshot" in out["stale_snapshot_offer"]["error"]
    ld, sn, fk = _snap_pair(wksp, snap_path, stale_path, snap_slot)
    _stream(ld, sn)
    m = sn.metrics_items()
    assert m["restored"] == 1 and m["slot"] == snap_slot, m
    from ..funk.shmfunk import WireFunk
    marker = WireFunk.from_plan(wksp, fk).rec_query(None,
                                                    RESTORE_MARKER_KEY)
    assert marker is not None and marker[0] == snap_slot, marker
    out["clean"] = {"accounts": m["accounts"], "slot": m["slot"]}
    return out


def snapld_crash_drill(snap_path: str, snap_slot: int,
                       name: str | None = None) -> dict:
    """crash_mid_snapshot on a supervised snapld (restart policy) in
    front of snapin on a shm store: snapld dies halfway through the
    file (exit 71), the supervisor restarts it, the new process streams
    from byte 0, and snapin restores the whole snapshot once. The frags
    are the least [snapshot] chunk, 64 bytes, so that the file outlasts
    the loader's first poll (16 frags) and the drill fires mid-file."""
    from ..disco import Topology, TopologyRunner
    topo = (
        Topology(name or f"cuk{os.getpid()}", wksp_size=1 << 25,
                 funk={"backend": "shm", "heap_mb": 4},
                 snapshot={"path": snap_path, "min_slot": snap_slot,
                           "chunk": 64})
        .link("snap_stream", depth=256, mtu=1 << 16)
        .tile("snapld", "snapld", outs=["snap_stream"],
              supervise={"policy": "restart", "backoff_s": 0.05,
                         "max_restarts": 3, "window_s": 60.0},
              chaos={"seed": 1, "events": [
                  {"action": "crash_mid_snapshot", "at_iter": 0}]})
        .tile("snapin", "snapin", ins=["snap_stream"]))
    runner = TopologyRunner(topo.build()).start()
    try:
        t0 = time.perf_counter()
        runner.wait_idle("snapin", "restored", 1, timeout_s=TIMEOUT_S,
                         poll_s=0.01)
        wall = time.perf_counter() - t0
        ld, sn = runner.metrics("snapld"), runner.metrics("snapin")
        store = store_root(runner.wksp, runner.plan["funk"])
    finally:
        runner.halt()
        runner.close()
    assert ld["sup_restarts"] == 1 and ld["done"] == 1, ld
    assert sn["restored"] == 1 and sn["slot"] == snap_slot \
        and sn["accounts"] == len(store), sn
    return {"restarts": ld["sup_restarts"], "loader_frags": ld["frags"],
            "snapin_frags": sn["frags"], "accounts": sn["accounts"],
            "wall_s": wall}


def _writer_child(snap_path: str, tail_path: str, out_path: str,
                  every: int, device: str):
    """Restore the snapshot into a process funk, replay the archived
    tail writing a snapshot every `every` slots, and arm
    crash_mid_snapshot once the first is written: the second write
    exits the process between rows."""
    from ..funk.funk import Funk
    from ..tiles.replay import InlineFanout, ReplayCore
    from ..utils.checkpt import (CheckptReader, RESTORE_MARKER_KEY,
                                 snapshot_restore_into)
    funk = Funk()
    with open(snap_path, "rb") as f:
        slot, bank_hash, _ = snapshot_restore_into(funk, f)
    core = ReplayCore(funk=funk, fanout=InlineFanout(funk, device=device),
                      verify_poh=False, wait_restore=True,
                      snapshot_path=out_path, snapshot_every=every,
                      device=device)
    funk.rec_write(None, RESTORE_MARKER_KEY, (slot, bank_hash))
    assert core.check_restore()
    with open(tail_path, "rb") as f:
        for frame in CheckptReader(f).frames():
            _, _, _, sz = struct.unpack_from("<QQHI", frame, 0)
            core.on_slice(frame[22:22 + sz])
            if core.metrics["snapshots"] == 1:
                core._crash_snap = True      # the chaos seam's arming


def writer_crash_drill(snap_path: str, tail_path: str, expected: dict,
                       snap_slot: int, out_dir: str, every: int = 2,
                       device="cuda") -> dict:
    """crash_mid_snapshot on the replay's snapshot writer, in a spawned
    process: it exits 72 inside its second write; the first snapshot
    file (slot snap_slot + every) is intact, restores, and carries the
    oracle's bank hash for its slot; the half-written .tmp is refused."""
    from ..funk.funk import Funk
    from ..utils.checkpt import CheckptError, snapshot_restore_into
    out_path = os.path.join(out_dir, "follower.ckpt")
    p = mp.get_context("spawn").Process(
        target=_writer_child,
        args=(snap_path, tail_path, out_path, every, device))
    t0 = time.perf_counter()
    p.start()
    p.join(TIMEOUT_S)
    wall = time.perf_counter() - t0
    if p.is_alive():
        p.kill()
        raise RuntimeError("the snapshot writer never crashed")
    assert p.exitcode == 72, p.exitcode
    first = (snap_slot // every + 1) * every
    with open(out_path, "rb") as f:
        slot, bank_hash, cnt = snapshot_restore_into(Funk(), f)
    assert slot == first and bank_hash.hex() == expected[str(first)], slot
    tmp = out_path + ".tmp"
    assert os.path.exists(tmp)
    try:
        with open(tmp, "rb") as f:
            snapshot_restore_into(Funk(), f)
    except CheckptError as e:
        refused = str(e)
    else:
        raise AssertionError("the half-written .tmp restored")
    return {"exitcode": p.exitcode, "intact_slot": slot, "records": cnt,
            "tmp_bytes": os.path.getsize(tmp), "tmp_refused": refused,
            "wall_s": wall}


def archive_accounts(n: int, seed: int = 0) -> dict:
    """{pubkey: Account} from `seed`: alternately a system account with
    no data and a token-account-sized one (165 bytes of data, a random
    owner)."""
    from ..svm.accdb import Account
    rng = np.random.default_rng(seed)
    keys = rng.bytes(32 * n)
    lam = rng.integers(1, 1 << 40, n)
    data = rng.bytes(165 * (n // 2))
    owners = rng.bytes(32 * (n // 2))
    out = {}
    for i in range(n):
        j = i // 2
        out[keys[32 * i:32 * i + 32]] = Account(
            int(lam[i]), data[165 * j:165 * j + 165] if i % 2 else b"",
            owners[32 * j:32 * j + 32] if i % 2 else bytes(32))
    return out


def write_archive(path: str, slot: int, accounts: dict, device="cuda"):
    """The accounts into a process funk, then write_snapshot_archive."""
    from ..flamenco.snapshot import write_snapshot_archive
    from ..funk.funk import Funk
    funk = Funk()
    for k, a in accounts.items():
        funk.rec_write(None, k, a)
    write_snapshot_archive(path, slot, funk, device=device)


def tamper_archive(path: str, out: str, slot: int):
    """Copy the archive with one lamport of its first account flipped."""
    from ..flamenco.snapshot import zstandard_module
    zstd = zstandard_module()
    with open(path, "rb") as f:
        raw = zstd.ZstdDecompressor().decompressobj().decompress(f.read())
    name = f"accounts/{slot}.0\x00".encode()
    idx = next(off for off in range(0, len(raw), 512)
               if raw[off:off + len(name)] == name)
    bad = bytearray(raw)
    bad[idx + 512 + 48] ^= 1          # its AccountMeta.lamports
    with open(out, "wb") as f:
        f.write(zstd.ZstdCompressor().compress(bytes(bad)))


def archive_restore(wksp, path: str, device="cuda") -> dict:
    """Stream the archive through snapld's, snapdc's and snapin's cores
    (SnapLoader -> SnapDecompress -> ArchiveInserter on `device`) on
    in-process rings. -> the inserter's metrics, its funk, the
    restore's wall and `error`: the inserter's RuntimeError (a failed
    lattice check) or None."""
    from ..runtime import Ring
    from ..tiles.snapshot import ArchiveInserter, SnapDecompress, SnapLoader
    mtu = 1 << 16
    a = Ring.create(wksp, depth=64, mtu=mtu)
    b = Ring.create(wksp, depth=256, mtu=mtu)
    t0 = time.perf_counter()
    ld = SnapLoader(path, a, [], chunk=mtu)
    dc = SnapDecompress(a, b, [])
    ai = ArchiveInserter(b, device=device)
    err = None
    try:
        while True:
            n = ld.poll_once()
            n += dc.poll_once()
            n += ai.poll_once()
            if not n and ld.metrics["done"] and dc.metrics["done"]:
                break
    except RuntimeError as e:
        err = str(e)
    return {"metrics": dict(ai.metrics), "funk": ai.funk, "error": err,
            "wall_s": time.perf_counter() - t0,
            "frags": {"snapld": ld.metrics["frags"],
                      "snapdc": dc.metrics["frags"]},
            "compressed_bytes": ld.metrics["bytes"],
            "raw_bytes": dc.metrics["out_bytes"]}


def write_fixture(out_dir: str = FIXTURE_DIR) -> dict:
    """bench.py's fixture at its defaults into `out_dir` (snap.ckpt,
    tail.arch): the files cfg/catchup.toml boots. -> the tail's
    expected bank hashes."""
    os.makedirs(out_dir, exist_ok=True)
    return catchup_fixture(out_dir)["expected"]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="firedancer_tpu_torch.tools.catchup")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--accounts", type=int, default=0)
    ap.add_argument("--write", nargs="?", const=FIXTURE_DIR, default=None,
                    metavar="DIR")
    a = ap.parse_args(argv)
    if a.write is not None:
        expected = write_fixture(a.write)
        print(json.dumps({"dir": a.write, "expected": expected}))
        return 0
    rec = run_catchup(device=a.device, accounts=a.accounts)
    print(json.dumps({k: rec[k] for k in (
        "catchup_slots", "catchup_count", "catchup_s", "replay_tps",
        "catchup_restore_slot", "catchup_divergent_slot",
        "catchup_exec_waves")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
