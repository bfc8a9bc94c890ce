"""The port's two-node cluster on one host: the leader
(firedancer_tpu_torch/cfg/leader.toml + cfg/cluster.toml, its shred tile
dropping every DROP_SLOT_EVERY-th slot from turbine) and the voting
non-leader (cfg/nonleader.toml), each a TopologyRunner, with ephemeral
ports by overrides as tests/test_repair_replay.py reserves them: the
non-leader's sock port is read from its metrics before the leader boots,
the leader's serve-only repair tile takes a port reserved beforehand, and
the send tile's votes go to a UDP socket of the caller's process. Used by
chip_smoke.py phase 24 and tests/test_torch_nonleader.py.

With `genesis_ckpt` the second node is the voting catch-up follower
(cfg/follower.toml: snapld -> snapin restore the checkpoint, a copy of it
at a path of the run's own, into the shm store; the replay waits for the
restore, replays turbine over two exec shards and snapshots every 64
slots; tower -> send -> sign vote), and the leader is the one app.dev
boots (`dev.leader_layers`: the same checkpoint in bank0) + cfg/cluster.toml,
dropping no slot: the follower has no repair tile. `follower_oracle`
replays the leader's slices on the CPU from that checkpoint, as the
follower does. Used by chip_smoke.py phase 25 and
tests/test_torch_follower_demo.py.

`Cluster.start` boots the non-leader, taps its slices and block frames
(tools/leader_drain.LinkTap), boots the leader once every tile of it runs
and taps its shred mirror.
`drain` waits, on the tiles' metrics only, until the leader's loop has
executed `count` frames (leader_drain.wait_drained) and poh has completed
the slot of its last microblock (close_slot) and two more, halts the
leader but its shred leg, which it drains, and its repair server
(leader_drain.drain_shred_leg), and waits until the non-leader has
replayed every slot up to that microblock's, a dropped slot included
once repair brought it back.
`stop` halts both, holds every tile to exit code 0 and returns the taps'
frames; `votes` gives the vote
datagrams, and `parse_vote` / `check_votes` hold each to the non-leader's
identity, its replayed slots and their bank hashes.
"""
from __future__ import annotations

import os
import shutil
import socket
import struct
import tempfile
import time

from . import leader_drain

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfg")
LEADER_TOMLS = (os.path.join(CFG, "leader.toml"),
                os.path.join(CFG, "cluster.toml"))
NONLEADER_TOML = os.path.join(CFG, "nonleader.toml")
FOLLOWER_TOML = os.path.join(CFG, "follower.toml")
# the leader's tiles on a card, the non-leader's and the follower's
LEADER_DEVICE_TILES = ("verify", "bank0")
NONLEADER_DEVICE_TILES = ("replay",)
FOLLOWER_DEVICE_TILES = ("replay", "exec", "snapin")
# the leader's shred tile withholds slots 3, 7, 11, ... from turbine
# (tests/test_repair_replay.py:318), so repair must carry them
DROP_SLOT_EVERY = 4


def dropped_slots(below: int) -> list[int]:
    """The slots under `below` that the leader withholds from turbine."""
    return [s for s in range(below)
            if s % DROP_SLOT_EVERY == DROP_SLOT_EVERY - 1]


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parse_tower_sync(data: bytes):
    """VoteInstruction::TowerSync's bincode (svm/vote.ix_tower_sync).
    -> ([(slot, conf)], root, hash, timestamp, block_id)."""
    disc, cnt = struct.unpack_from("<IQ", data, 0)
    if disc != 14:
        raise ValueError(f"not a TowerSync (disc {disc})")
    off, lockouts = 12, []
    for _ in range(cnt):
        lockouts.append(struct.unpack_from("<QI", data, off))
        off += 12
    root = None
    if data[off]:
        (root,) = struct.unpack_from("<Q", data, off + 1)
        off += 9
    else:
        off += 1
    bank_hash = bytes(data[off:off + 32])
    off += 32
    ts = None
    if data[off]:
        (ts,) = struct.unpack_from("<q", data, off + 1)
        off += 9
    else:
        off += 1
    block_id = bytes(data[off:off + 32])
    if off + 32 != len(data):
        raise ValueError("TowerSync of the wrong length")
    return lockouts, root, bank_hash, ts, block_id


def parse_vote(datagram: bytes):
    """A send tile's vote txn. -> (signer, signature, message,
    TowerSync fields)."""
    from ..protocol.txn import parse_txn
    from ..svm.vote import VOTE_PROGRAM_ID
    t = parse_txn(datagram)
    keys = t.account_keys(datagram)
    (ix,) = t.instrs
    if keys[ix.prog_idx] != VOTE_PROGRAM_ID:
        raise ValueError("not a vote program instruction")
    return (keys[0], t.signatures(datagram)[0], t.message(datagram),
            parse_tower_sync(datagram[ix.data_off:ix.data_off
                                      + ix.data_sz]))


def check_votes(datagrams, identity: bytes, bank_hash_of: dict) -> list:
    """Every vote: signed by `identity` (utils/ed25519_ref), a TowerSync
    whose lockout slots ascend and are replayed slots (keys of
    `bank_hash_of`), whose hash and block id are the bank hash of its
    last lockout slot, and whose blockhash is that hash too. Raises
    AssertionError. -> [(last lockout slot, lockouts, root)]."""
    from ..protocol.txn import parse_txn
    from ..utils.ed25519_ref import verify
    out = []
    for d in datagrams:
        signer, sig, msg, (lockouts, root, bank_hash, _, block_id) = \
            parse_vote(d)
        assert signer == identity, "a vote not signed by the non-leader"
        assert verify(sig, identity, msg), "a vote's signature fails"
        slots = [s for s, _ in lockouts]
        assert slots and slots == sorted(set(slots)), slots
        assert all(s in bank_hash_of for s in slots), slots
        want = bank_hash_of[slots[-1]]
        assert bank_hash == block_id == want, slots[-1]
        t = parse_txn(d)
        assert d[t.blockhash_off:t.blockhash_off + 32] == want
        assert root is None or root < slots[0]
        out.append((slots[-1], lockouts, root))
    return out


def follower_oracle(slices, genesis_ckpt: str, hashes_per_tick: int,
                    store_slot: int | None = None):
    """The follower's replay on the CPU, in process, without its PoH
    check: the port's ReplayCore over InlineFanout (plain versions) on a
    process funk restored from `genesis_ckpt` as snapin restores it
    (utils/checkpt.snapshot_restore_into), seeded by the restore gate
    (check_restore), then `slices` (slice frames in arrival order) in one
    release, or two split after slot `store_slot`. -> (core, every
    account at the root once `store_slot` has replayed, or None)."""
    from ..funk.funk import Funk
    from ..tiles.replay import InlineFanout, ReplayCore
    from ..tiles.shred import parse_slice
    from ..utils.checkpt import RESTORE_MARKER_KEY, snapshot_restore_into
    funk = Funk()
    with open(genesis_ckpt, "rb") as f:
        slot, bank_hash, _ = snapshot_restore_into(funk, f)
    # bank hashes and stores only: the follower's replay tile checks PoH
    # itself, and a bank hash takes the entries' tips as given
    core = ReplayCore(funk=funk, fanout=InlineFanout(funk, device="cpu"),
                      hashes_per_tick=hashes_per_tick, verify_poh=False,
                      wait_restore=True, device="cpu")
    funk.rec_write(None, RESTORE_MARKER_KEY, (slot, bank_hash))
    assert core.check_restore()
    store = None
    if store_slot is None:
        core.on_slices(slices)
    else:
        core.on_slices([f for f in slices
                        if parse_slice(f)[0] <= store_slot])
        store = dict(funk.root_items())
        store.pop(RESTORE_MARKER_KEY, None)
        core.on_slices([f for f in slices
                        if parse_slice(f)[0] > store_slot])
    return core, store


class Cluster:
    """The two topologies on this host. `leader_tiles` and
    `nonleader_tiles` are extra [[tile]] overrides by name (the latter
    for the second node, non-leader or follower); `device` goes to the
    verify shards, bank0 and the second node's device tiles. With
    `genesis_ckpt` the second node is the follower and the leader drops
    no slot."""

    def __init__(self, name: str, device: str, leader_tiles=(),
                 nonleader_tiles=(), genesis_ckpt: str | None = None):
        self.name, self.device = name, device
        self.leader_tiles = list(leader_tiles)
        self.nonleader_tiles = list(nonleader_tiles)
        self.genesis_ckpt = genesis_ckpt
        self.tmp = None
        self.snapshot_path = None
        self.a = self.b = None
        self.taps = {}
        self.rx = None
        self.vote_log: list[bytes] = []

    @property
    def follower(self) -> bool:
        return self.genesis_ckpt is not None

    def nonleader_config(self, repair_port: int, vote_dest: str) -> dict:
        from ..app.config import load_config
        return load_config(NONLEADER_TOML, overrides={"tile": [
            {"name": "sock", "port": 0},
            {"name": "repair", "peers": [{
                "pubkey_hex": self.leader_identity().hex(),
                "addr": f"127.0.0.1:{repair_port}"}]},
            {"name": "send", "dest": vote_dest},
            *({"name": tn, "device": self.device}
              for tn in NONLEADER_DEVICE_TILES),
            *self.nonleader_tiles]})

    def follower_config(self, vote_dest: str, snapshot_path: str) -> dict:
        """cfg/follower.toml on an ephemeral sock port, its votes to
        `vote_dest` and its snapshot (snapld's source and the replay's
        writer) at `snapshot_path`."""
        from ..app.config import load_config
        return load_config(FOLLOWER_TOML, overrides={
            "snapshot": {"path": snapshot_path},
            "tile": [
                {"name": "sock", "port": 0},
                {"name": "send", "dest": vote_dest},
                *({"name": tn, "device": self.device}
                  for tn in FOLLOWER_DEVICE_TILES),
                *self.nonleader_tiles]})

    def leader_layers(self) -> list[str]:
        """The leader's TOML layers: app.dev's (cfg/leader.toml and the
        overlay with the genesis in bank0) for the follower, else
        cfg/leader.toml; then cfg/cluster.toml."""
        if not self.follower:
            return list(LEADER_TOMLS)
        from ..app.dev import leader_layers
        return [*leader_layers(self.genesis_ckpt, self.tmp),
                LEADER_TOMLS[1]]

    def leader_config(self, sock_port: int, repair_port: int) -> dict:
        from ..app.config import load_config
        layers = self.leader_layers()
        cfg = load_config(*layers)
        shred = next(t for t in cfg["tile"] if t["name"] == "shred")
        cluster = [dict(n, addr=f"127.0.0.1:{sock_port}")
                   for n in shred["cluster"]]
        return load_config(*layers, overrides={"tile": [
            {"name": "shred", "cluster": cluster,
             "drop_slot_every": 0 if self.follower else DROP_SLOT_EVERY},
            {"name": "arepair", "port": repair_port},
            *({"name": tn, "device": self.device}
              for tn in LEADER_DEVICE_TILES),
            *self.leader_tiles]})

    @staticmethod
    def leader_identity() -> bytes:
        from ..app.config import load_config
        cfg = load_config(*LEADER_TOMLS)
        return bytes.fromhex(next(t["identity_hex"] for t in cfg["tile"]
                                  if t["name"] == "shred"))

    @staticmethod
    def voter_identity(toml: str = NONLEADER_TOML) -> bytes:
        """The send tile's identity in `toml` (the node's vote signer)."""
        from ..app.config import load_config
        cfg = load_config(toml)
        return bytes.fromhex(next(t["identity_hex"] for t in cfg["tile"]
                                  if t["name"] == "send"))

    @staticmethod
    def nonleader_identity() -> bytes:
        return Cluster.voter_identity(NONLEADER_TOML)

    @staticmethod
    def follower_identity() -> bytes:
        return Cluster.voter_identity(FOLLOWER_TOML)

    def start(self, boot_timeout_s: float = 300.0):
        from ..app.config import build_topology
        from ..disco.launch import TopologyRunner
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("127.0.0.1", 0))
        self.rx.setblocking(False)
        repair_port = free_udp_port()
        vote_dest = f"127.0.0.1:{self.rx.getsockname()[1]}"
        if self.follower:
            # the follower's snapshot path is the run's own: snapld
            # streams the genesis from it and the replay's writer
            # replaces it, so two runs never share the file
            self.tmp = tempfile.mkdtemp(prefix=f"fdtt_{self.name}_")
            self.snapshot_path = os.path.join(self.tmp, "follower.ckpt")
            shutil.copyfile(self.genesis_ckpt, self.snapshot_path)
            self.b_cfg = self.follower_config(vote_dest, self.snapshot_path)
        else:
            self.b_cfg = self.nonleader_config(repair_port, vote_dest)
        self.b = TopologyRunner(build_topology(
            self.b_cfg, name=f"{self.name}b{os.getpid()}").build())
        self.b.start()
        for ln in ("shred_slices", "replay_tower"):
            self.taps[ln] = leader_drain.LinkTap(self.b, ln, batch=64)
        # every tile of the second node runs before the leader's first
        # shred: the follower has no repair, and a non-leader booted
        # beside its leader starts far behind it, which on a loaded host
        # ends in repair requests the server must refuse
        self.b.wait_running(timeout_s=boot_timeout_s)
        self.wait(lambda: self.b.metrics("sock")["port"] != 0, 30,
                  "the second node's sock port")
        self.a_cfg = self.leader_config(
            int(self.b.metrics("sock")["port"]), repair_port)
        self.a = TopologyRunner(build_topology(
            self.a_cfg, name=f"{self.name}a{os.getpid()}").build())
        self.a.start()
        self.taps["shreds_mirror"] = leader_drain.LinkTap(
            self.a, "shreds_mirror", batch=256)
        self.a.wait_running(timeout_s=boot_timeout_s)
        return self

    def wait(self, cond, timeout_s: float, what: str,
             poll_s: float = 0.01):
        """Block until cond() holds; a dead tile in either topology
        raises at once."""
        deadline = time.monotonic() + timeout_s
        while not cond():
            self.votes()
            for r in (self.a, self.b):
                if r is not None:
                    r.check_failures()
            if time.monotonic() > deadline:
                raise TimeoutError(f"timed out waiting for {what}")
            time.sleep(poll_s)

    def drain(self, count: int, timeout_s: float) -> dict:
        """The leader executes its `count` frames and closes the slot of
        the last (S - 1, poh having completed S slots); poh completes two
        slots more, whose shreds name S - 1 as an ancestor (a dropped
        slot is known only from its children's shreds), and, for the
        follower, at least every_slots + 1 of its [snapshot] in all, so
        that its first snapshot slot comes; then every leader tile halts
        but the shred leg, which ships every entry poh made, and the
        serve-only repair tile, which stays (the non-leader's repair
        window is the last 512 slots the server holds, so the leader must
        not run ahead of a slow non-leader). With L = S, or for the
        follower max(S, every_slots + 1), the non-leader replays every
        slot below L; the follower, restored at slot 0, replays slots 1
        to L - 1 (slot 0 is its snapshot's: the replay never runs a slot
        at or below the restore slot, as the reference's). Last, the
        second node's send tile sends every vote its tower has made.
        -> {"slots": S, "replayed": the slots the second node replayed
        at least, "dropped": frames dropped at a named hop, "wall_s":
        seconds from the call, "steps_s": {step: seconds}}."""
        t0 = time.perf_counter()
        steps, t_step = {}, t0

        def step(name):
            nonlocal t_step
            now = time.perf_counter()
            steps[name], t_step = now - t_step, now

        self.a.wait_idle("synth", "tx", count, timeout_s=timeout_s,
                         poll_s=0.002)
        dropped = leader_drain.wait_drained(self.a, count,
                                            timeout_s=timeout_s)
        step("executed")
        slots = leader_drain.close_slot(self.a, timeout_s=timeout_s)
        last = max(slots, self.b_cfg["snapshot"]["every_slots"] + 1) \
            if self.follower else slots
        self.wait(lambda: self.a.metrics("poh")["slots"]
                  >= max(slots + 2, last), timeout_s,
                  f"poh's slot {max(slots + 1, last - 1)}")
        step("poh")
        # a poh halted while backpressured drops the entries it staged:
        # halt it while its entry ring has room
        room = self.a.plan["links"]["poh_entries"]["depth"] // 2
        self.wait(lambda: self.a.metrics("poh")["entries"]
                  - self.a.metrics("shred")["entries"] < room, timeout_s,
                  "the shred tile within half a ring of poh")
        leader_drain.drain_shred_leg(self.a, timeout_s=timeout_s,
                                     keep=("arepair",))
        step("shred_leg")
        need = last - 1 if self.follower else last
        try:
            self.wait(lambda: self.b.metrics("replay")["slots_replayed"]
                      >= need, timeout_s,
                      f"the second node's replay of {need} slots")
        except TimeoutError:
            m = self.b.metrics("replay")
            raise TimeoutError(
                f"the second node stalled at slot "
                f"{m['restore_slot'] + m['slots_replayed'] + self.follower}"
                f" ({m['slots_replayed']} of {need} slots replayed, "
                f"{m['buffered']} buffered, poh slots {last})") from None
        step("replay")

        # the send tile signs each vote through the sign tile, behind the
        # repair tile's requests: every vote the tower has made is sent
        # before the halt
        def voted():
            t, sd = self.b.metrics("tower"), self.b.metrics("send")
            return sd["votes"] == t["votes_out"] \
                and sd["sent"] + sd["sign_fail"] == sd["votes"]
        self.wait(voted, timeout_s, "the send tile's votes")
        step("votes")
        return {"slots": slots, "replayed": need, "dropped": dropped,
                "wall_s": time.perf_counter() - t0, "steps_s": steps}

    def votes(self) -> list[bytes]:
        """Every vote datagram received so far (each wait reads the
        socket too, so that its buffer never fills)."""
        while True:
            try:
                self.vote_log.append(self.rx.recvfrom(2048)[0])
            except BlockingIOError:
                return list(self.vote_log)

    def stop(self) -> dict:
        """Halt both topologies (the non-leader first, so that its repair
        never outlives its server) and assert that every tile exited 0 (a
        tile that misses the halt's join is terminated and fails it); then
        read the vote socket once more, so that `vote_log` holds every
        vote the send tile sent before it exited.
        -> {link: every tapped frame}, with `metrics` {"leader": {tile:
        ...}, "nonleader" or "follower": {...}} read after the stems
        flushed them."""
        out = {"metrics": {}}
        second = "follower" if self.follower else "nonleader"
        for key, r in ((second, self.b), ("leader", self.a)):
            if r is not None:
                r.halt()
                for tn, p in r.procs.items():
                    assert p.exitcode == 0, \
                        f"{key} tile {tn} exit code {p.exitcode}"
                out["metrics"][key] = {tn: r.metrics(tn)
                                       for tn in r.plan["tiles"]}
        if self.rx is not None:
            self.votes()
        for ln, tap in self.taps.items():
            out[ln] = tap.stop()
        self.taps = {}
        return out

    def close(self):
        for tap in self.taps.values():
            tap.close()
        self.taps = {}
        for r in (self.b, self.a):
            if r is not None:
                r.halt()
                r.close()
        if self.rx is not None:
            self.rx.close()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
