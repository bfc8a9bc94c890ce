"""Drains of the leader topology (firedancer_tpu_torch/cfg/leader.toml,
cfg/leader_follower.toml with its follower leg, and cfg/exec.toml's
exec tile family) booted by a TopologyRunner, and the checks of what it
mirrored; used by chip_smoke.py phases 12, 17 and 20, by
tools/general_exec.py and tools/cluster.py (phases 23 and 24), and by
tests/test_torch_leader.py, test_torch_follower.py and
test_torch_exec_tile.py.

`wait_drained` is bench.py's `_leader_wait_drained` (bench.py:554-583):
every synth frame has a terminal outcome, executed by bank0 or dropped at
a named hop (with a resolv tile, its parse, lookup-table, fee-payer and
oversize drops too), and pack has retired every microblock; unlike
bench.py it reads pack's retirement only from a flush of pack's metrics
that has scheduled every txn bank0 took. The loop itself never
goes quiet (poh ticks on), so `drain_shred_leg` then halts every tile
upstream of the shred tile, whose stems flush what they staged, waits
until the shred tile has taken every entry poh published and shredsink
every wire the shred tile mirrored, and halts the rest but the tiles it
is told to keep. `wait_mixed` waits until poh has mixed in every
microblock bank0 executed. With a follower, `close_slot` first lets poh
complete the slot that holds the last executed microblock, and
`drain_follower` then waits until the replay tile has replayed every
slot poh completed, and halts them. `check_mirror` reads
the shreds still in the mirror ring and holds each to its FEC set's
merkle root (its proof) and the root to the set's signature;
`tower_blocks` reads the replay tile's block frames still in its ring;
`wait_restarted` waits out a drill's crashed tile's respawn;
`LinkTap` keeps every frame a link publishes, from its first, where the
ring holds only its last `depth`.
"""
from __future__ import annotations

import threading
import time

SHRED_LEG = ("shred", "sign", "shredsink")
FOLLOWER_LEG = ("shredr", "replay", "towersink")


def verify_shards(runner) -> list[str]:
    return [tn for tn in runner.plan["tiles"] if tn.startswith("verify")]


def dropped(runner) -> int:
    """Frames dropped at a named hop: dedup's duplicates, pack's parse
    failures, each verify shard's parse, dedup and verify failures, and
    a resolv tile's parse, lookup-table, fee-payer and oversize drops
    (bench.py's `resolv=True`)."""
    n = runner.metrics("dedup")["dup"] + runner.metrics("pack")["parse_fail"]
    if "resolv" in runner.plan["tiles"]:
        r = runner.metrics("resolv")
        n += r["parse_fail"] + r["alut_fail"] + r["fee_fail"] + r["oversz"]
    for tn in verify_shards(runner):
        v = runner.metrics(tn)
        n += v["parse_fail"] + v["dedup_drop"] + v["verify_fail"]
    return n


def wait_drained(runner, count: int, timeout_s: float,
                 poll_s: float = 0.002) -> int:
    """Block until bank0's txns plus the dropped frames reach `count`
    and pack's completions equal its microblocks, in a snapshot of
    pack's metrics that has scheduled every txn bank0 took: each tile
    flushes its metrics at its own cadence, and an older flush of pack
    can show its completions equal to its microblocks before the last
    microblocks. -> dropped."""
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        p, b = runner.metrics("pack"), runner.metrics("bank0")
        d = dropped(runner)
        if b["txns"] + d >= count and p["scheduled"] >= b["txns"] \
                and p["completions"] == p["microblocks"]:
            return d
        if time.monotonic() > deadline:
            raise TimeoutError(f"leader loop never drained: pack {p}, "
                               f"bank {b}, dropped {d}")
        time.sleep(poll_s)


def wait_restarted(runner, tile: str, timeout_s: float,
                   poll_s: float = 0.01) -> int:
    """Block until the supervisor has respawned `tile` at least once and
    the respawn is running (a drill's crash can land after the loop has
    drained: a halt must not find the tile dead or half booted).
    -> its restarts."""
    from ..runtime import CNC_RUN
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        n = runner.metrics(tile)["sup_restarts"]
        if n >= 1 and runner._cnc(tile).state == CNC_RUN:
            return n
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tile} was not respawned and running: "
                               f"{runner.metrics(tile)}")
        time.sleep(poll_s)


def wait_mixed(runner, timeout_s: float, poll_s: float = 0.002):
    """After wait_drained: wait until poh has mixed in every microblock
    bank0 executed (the tiles halt together, and the last microblock may
    still be in the bank0 -> poh link)."""
    deadline = time.monotonic() + timeout_s
    while runner.metrics("poh")["mixins"] < \
            runner.metrics("bank0")["microblocks"]:
        runner.check_failures()
        if time.monotonic() > deadline:
            raise TimeoutError("poh never mixed in every microblock")
        time.sleep(poll_s)


def close_slot(runner, timeout_s: float, poll_s: float = 0.002) -> int:
    """After wait_drained: wait until poh has mixed in every microblock
    bank0 executed and then completed the slot the last of them went
    into, so a follower replays every executed transaction (halting poh
    at once would leave them in a slot that never completes).
    -> poh's completed slots."""
    deadline = time.monotonic() + timeout_s
    wait_mixed(runner, timeout_s, poll_s)
    target = runner.metrics("poh")["slots"] + 1
    while (slots := runner.metrics("poh")["slots"]) < target:
        runner.check_failures()
        if time.monotonic() > deadline:
            raise TimeoutError(f"poh never completed slot {target - 1}")
        time.sleep(poll_s)
    return slots


def drain_shred_leg(runner, timeout_s: float, poll_s: float = 0.01,
                    keep=()) -> dict:
    """Halt every tile but the shred leg and `keep`; wait until
    shred.entries equals poh.entries and shredsink.rx equals the shreds
    the shred tile made (data + parity); halt the shred leg.
    -> {tile: metrics}."""
    runner.halt(tiles=[tn for tn in runner.procs
                       if tn not in SHRED_LEG and tn not in keep])
    poh_entries = runner.metrics("poh")["entries"]
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        s, snk = runner.metrics("shred"), runner.metrics("shredsink")
        made = s["data_shreds"] + s["parity_shreds"]
        if s["entries"] == poh_entries and snk["rx"] == made:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"shred leg never drained: poh entries "
                               f"{poh_entries}, shred {s}, shredsink {snk}")
        time.sleep(poll_s)
    runner.halt(tiles=[tn for tn in runner.procs if tn not in keep])
    return {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}


def drain_follower(runner, slots: int, timeout_s: float,
                   poll_s: float = 0.01) -> dict:
    """After drain_shred_leg(..., keep=FOLLOWER_LEG): wait until
    replay.slots_replayed equals `slots` (poh's published slots) and
    towersink has a frame for each, then halt every tile.
    -> {tile: metrics}."""
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        r, t = runner.metrics("replay"), runner.metrics("towersink")
        if r["slots_replayed"] >= slots and t["rx"] >= slots:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"follower never drained: {slots} slots, "
                               f"replay {r}, shredr "
                               f"{runner.metrics('shredr')}")
        time.sleep(poll_s)
    runner.halt()
    return {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}


def _ring(runner, link: str):
    from ..runtime import Ring
    li = runner.plan["links"][link]
    return Ring(runner.wksp, li["ring_off"], li["depth"], li["arena_off"],
                li["mtu"])


def link_frames(runner, link: str) -> list[bytes]:
    """Every frame still in the link's ring, oldest first (the ring holds
    its last `depth` frames)."""
    ring = _ring(runner, link)
    seq = max(0, int(ring.seq) - ring.depth)
    out = []
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out
        out.append(bytes(ring.payload(frag)))
        seq += 1


def mirror_wires(runner, link: str = "shreds_mirror") -> list[bytes]:
    """Every wire still in the mirror ring, oldest first."""
    return link_frames(runner, link)


def tower_blocks(runner, link: str = "replay_tower") -> list[tuple]:
    """The replay tile's block frames still in its tower link, oldest
    first: [(slot, parent_slot, block_id, parent_id)], the block id being
    the slot's bank hash."""
    from ..tiles.tower import parse_block
    return [parse_block(f) for f in link_frames(runner, link)]


class LinkTap:
    """Every frame a link publishes, from its first, copied on a thread
    of the caller's process as the ring fills (an unreliable reader: it
    holds no producer back), with the host-clock time (perf_counter) at
    which the tap took it. Start it before the producer can lap the
    ring; `stop` raises if the producer ever overran it."""

    def __init__(self, runner, link: str, poll_s: float = 0.002,
                 batch: int = 256):
        self.ring = _ring(runner, link)
        self.mtu = runner.plan["links"][link]["mtu"]
        self.link, self.poll_s, self.batch = link, poll_s, batch
        self.seq, self.frames, self.times, self.overruns = 0, [], [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _drain(self) -> int:
        if self.ring.seq == self.seq:
            return 0             # nothing new: no gather buffer
        n, self.seq, buf, sizes, _, ovr = self.ring.gather(
            self.seq, self.batch, self.mtu)
        self.overruns += int(ovr)
        self.frames += [bytes(buf[i, :sizes[i]]) for i in range(n)]
        self.times += [time.perf_counter()] * n
        return n

    def _run(self):
        while not self._stop.is_set():
            if not self._drain():
                time.sleep(self.poll_s)

    def close(self):
        """End the tap's thread (again: a no-op); the ring may be
        unmapped after it."""
        self._stop.set()
        self._thread.join()

    def stop(self) -> list[bytes]:
        """Stop, take what is left, and return every frame in order."""
        self.close()
        while self._drain():
            pass
        if self.overruns:
            raise AssertionError(f"link {self.link}: the tap was overrun "
                                 f"{self.overruns} times")
        return self.frames


def check_mirror(wires, pubkey: bytes) -> int:
    """Each shred's proof leads from its merkle leaf to one root for its
    FEC set, and the set's signature verifies under `pubkey` over that
    root (the check of tests/test_shred.py:150, from the wires alone).
    Raises AssertionError. -> the number of FEC sets seen."""
    from ..shred import format as fmt
    from ..shred.merkle import root_from_proof, shred_merkle_leaf
    from ..utils.ed25519_ref import verify
    roots: dict = {}
    for w in wires:
        s = fmt.parse_shred(w)
        if fmt.is_data(s.variant):
            leaf_idx = s.idx - s.fec_set_idx
            region = fmt.data_merkle_region_sz(s.variant)
        else:
            leaf_idx = s.data_cnt + s.code_idx
            region = fmt.code_merkle_region_sz(s.variant)
        root = root_from_proof(shred_merkle_leaf(w[64:64 + region]),
                               leaf_idx, list(s.proof))
        key = (s.slot, s.fec_set_idx)
        if key not in roots:
            assert verify(s.signature, pubkey, root), \
                f"set {key}: signature does not cover its root"
            roots[key] = (root, s.signature)
        assert roots[key] == (root, s.signature), \
            f"set {key}: shred {s.idx} proves another root"
    return len(roots)
