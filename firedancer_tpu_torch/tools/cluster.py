"""The port's two-node cluster on one host: the leader
(firedancer_tpu_torch/cfg/leader.toml + cfg/cluster.toml, its shred tile
dropping every DROP_SLOT_EVERY-th slot from turbine) and the voting
non-leader (cfg/nonleader.toml), each a TopologyRunner, with ephemeral
ports by overrides as tests/test_repair_replay.py reserves them: the
non-leader's sock port is read from its metrics before the leader boots,
the leader's serve-only repair tile takes a port reserved beforehand, and
the send tile's votes go to a UDP socket of the caller's process. Used by
chip_smoke.py phase 24 and tests/test_torch_nonleader.py.

`Cluster.start` boots the non-leader, taps its slices and block frames
(tools/leader_drain.LinkTap), boots the leader and taps its shred mirror.
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
import socket
import struct
import time

from . import leader_drain

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfg")
LEADER_TOMLS = (os.path.join(CFG, "leader.toml"),
                os.path.join(CFG, "cluster.toml"))
NONLEADER_TOML = os.path.join(CFG, "nonleader.toml")
# the leader's tiles on a card, and the non-leader's
LEADER_DEVICE_TILES = ("verify", "bank0")
NONLEADER_DEVICE_TILES = ("replay",)
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


class Cluster:
    """The two topologies on this host. `leader_tiles` and
    `nonleader_tiles` are extra [[tile]] overrides by name; `device` goes
    to the verify shards, bank0 and the replay."""

    def __init__(self, name: str, device: str, leader_tiles=(),
                 nonleader_tiles=()):
        self.name, self.device = name, device
        self.leader_tiles = list(leader_tiles)
        self.nonleader_tiles = list(nonleader_tiles)
        self.a = self.b = None
        self.taps = {}
        self.rx = None
        self.vote_log: list[bytes] = []

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

    def leader_config(self, sock_port: int, repair_port: int) -> dict:
        from ..app.config import load_config
        cfg = load_config(*LEADER_TOMLS)
        shred = next(t for t in cfg["tile"] if t["name"] == "shred")
        cluster = [dict(n, addr=f"127.0.0.1:{sock_port}")
                   for n in shred["cluster"]]
        return load_config(*LEADER_TOMLS, overrides={"tile": [
            {"name": "shred", "cluster": cluster,
             "drop_slot_every": DROP_SLOT_EVERY},
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
    def nonleader_identity() -> bytes:
        from ..app.config import load_config
        cfg = load_config(NONLEADER_TOML)
        return bytes.fromhex(next(t["identity_hex"] for t in cfg["tile"]
                                  if t["name"] == "send"))

    def start(self, boot_timeout_s: float = 300.0):
        from ..app.config import build_topology
        from ..disco.launch import TopologyRunner
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("127.0.0.1", 0))
        self.rx.setblocking(False)
        repair_port = free_udp_port()
        self.b_cfg = self.nonleader_config(
            repair_port, f"127.0.0.1:{self.rx.getsockname()[1]}")
        self.b = TopologyRunner(build_topology(
            self.b_cfg, name=f"{self.name}b{os.getpid()}").build())
        self.b.start()
        for ln in ("shred_slices", "replay_tower"):
            self.taps[ln] = leader_drain.LinkTap(self.b, ln, batch=64)
        self.b.wait_running(timeout_s=boot_timeout_s)
        self.wait(lambda: self.b.metrics("sock")["port"] != 0, 30,
                  "the non-leader's sock port")
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
        slot is known only from its children's shreds); then every
        leader tile halts but the shred leg, which ships every entry
        poh made, and the serve-only repair tile, which stays (the
        non-leader's repair window is the last 512 slots the server
        holds, so the leader must not run ahead of a slow non-leader);
        the non-leader replays every slot below S.
        -> {"slots": S, "dropped": frames dropped at a named hop,
        "wall_s": seconds from the call}."""
        t0 = time.perf_counter()
        self.a.wait_idle("synth", "tx", count, timeout_s=timeout_s,
                         poll_s=0.002)
        dropped = leader_drain.wait_drained(self.a, count,
                                            timeout_s=timeout_s)
        slots = leader_drain.close_slot(self.a, timeout_s=timeout_s)
        self.wait(lambda: self.a.metrics("poh")["slots"] >= slots + 2,
                  timeout_s, f"poh's slot {slots + 1}")
        # a poh halted while backpressured drops the entries it staged:
        # halt it while its entry ring has room
        room = self.a.plan["links"]["poh_entries"]["depth"] // 2
        self.wait(lambda: self.a.metrics("poh")["entries"]
                  - self.a.metrics("shred")["entries"] < room, timeout_s,
                  "the shred tile within half a ring of poh")
        leader_drain.drain_shred_leg(self.a, timeout_s=timeout_s,
                                     keep=("arepair",))
        self.wait(lambda: self.b.metrics("replay")["slots_replayed"]
                  >= slots, timeout_s,
                  f"the non-leader's replay of {slots} slots")
        return {"slots": slots, "dropped": dropped,
                "wall_s": time.perf_counter() - t0}

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
        tile that misses the halt's join is terminated and fails it);
        -> {link: every tapped frame}, with `metrics` {"leader": {tile:
        ...}, "nonleader": {...}} read after the stems flushed them."""
        out = {"metrics": {}}
        for key, r in (("nonleader", self.b), ("leader", self.a)):
            if r is not None:
                r.halt()
                for tn, p in r.procs.items():
                    assert p.exitcode == 0, \
                        f"{key} tile {tn} exit code {p.exitcode}"
                out["metrics"][key] = {tn: r.metrics(tn)
                                       for tn in r.plan["tiles"]}
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
