"""Tower tile + send tile cores: fork choice -> vote -> signed egress
(copy of the JAX package's tiles/tower.py, with `parse_block` added and
the vote frame's `pack_tower_vote` / `parse_tower_vote`, which the
reference's TowerAdapter and SendAdapter inline).

The reference's tower tile consumes replay's block notifications and
vote aggregates, runs choreo (ghost weights + tower checks), and hands
its vote to the send tile, which builds the vote transaction and signs
it through the keyguard before egress (ref: src/discof/tower/
fd_tower_tile.c consuming choreo, src/discof/send/ vote egress,
keyguard role SEND).

Input frames (one link, the replay/gossip fan-in):
  u8 0 BLOCK: u64 slot | u64 parent_slot | 32 block_id | 32 parent_id
  u8 1 VOTE:  32 voter | u64 stake | 32 block_id
Output frames (votes link, `pack_tower_vote` / `parse_tower_vote`):
  u64 slot | 32 block_id | u8 has_root [u64 root] | u16 n |
  n x (u64 slot, u32 conf)   (own vote decision and the whole tower)

Per-voter towers are reconstructed from the observed vote stream (each
VOTE frame pushes the voted slot through the same TowerBFT expiry
rules), so the depth-8 threshold check runs for real alongside lockout
and switch — the reference reads the equivalent state out of the vote
accounts the replay stage landed (ref: fd_tower_tile.c vote account
sync).
"""
from __future__ import annotations

import struct

from ..choreo import Ghost, Tower

FRAME_BLOCK = 0
FRAME_VOTE = 1


def pack_block(slot: int, parent_slot: int, block_id: bytes,
               parent_id: bytes) -> bytes:
    return (bytes([FRAME_BLOCK]) + struct.pack("<QQ", slot, parent_slot)
            + block_id + parent_id)


def parse_block(frame: bytes):
    """-> (slot, parent_slot, block_id, parent_id) of a BLOCK frame."""
    if frame[0] != FRAME_BLOCK:
        raise ValueError(f"not a BLOCK frame (type {frame[0]})")
    slot, parent_slot = struct.unpack_from("<QQ", frame, 1)
    return slot, parent_slot, bytes(frame[17:49]), bytes(frame[49:81])


def pack_vote(voter: bytes, stake: int, block_id: bytes) -> bytes:
    return bytes([FRAME_VOTE]) + voter + struct.pack("<Q", stake) \
        + block_id


def pack_tower_vote(slot: int, block_id: bytes, tower: Tower) -> bytes:
    """The tower tile's vote frame: the decision and the FULL tower (its
    root and its last 31 lockouts, the tower depth cap), so the send tile
    can build a real TowerSync instruction (the reference's
    TowerAdapter.housekeeping)."""
    frame = struct.pack("<Q", slot) + block_id
    frame += (bytes([1]) + struct.pack("<Q", tower.root)
              if tower.root is not None else bytes([0]))
    votes = list(tower.votes)[-31:]
    frame += struct.pack("<H", len(votes))
    for v in votes:
        frame += struct.pack("<QI", v.slot, v.conf)
    return frame


def parse_tower_vote(frame: bytes):
    """-> (slot, block_id, [(slot, conf)], root) of a vote frame; a frame
    of the decision alone has no lockouts and no root (the reference's
    SendAdapter.poll_once)."""
    (slot,) = struct.unpack_from("<Q", frame, 0)
    block_id = bytes(frame[8:40])
    lockouts, root = [], None
    if len(frame) > 40:
        off = 40
        if frame[off]:
            (root,) = struct.unpack_from("<Q", frame, off + 1)
            off += 9
        else:
            off += 1
        (cnt,) = struct.unpack_from("<H", frame, off)
        off += 2
        for _ in range(cnt):
            lockouts.append(struct.unpack_from("<QI", frame, off))
            off += 12
    return slot, block_id, lockouts, root


class TowerCore:
    def __init__(self, total_stake: int):
        self.total_stake = total_stake
        self.ghost: Ghost | None = None
        self.tower = Tower()
        self.vote_blocks: dict[int, bytes] = {}
        self.slot_of: dict[bytes, int] = {}
        self.last_vote_block: bytes | None = None
        # voter pubkey -> (stake, replayed Tower); rebuilt from the
        # vote stream so threshold_check sees every voter's lockouts
        self.voter_towers: dict[bytes, list] = {}
        self.metrics = {"blocks": 0, "votes_in": 0, "votes_out": 0,
                        "lockout_skips": 0, "switch_skips": 0,
                        "threshold_skips": 0,
                        "roots": 0, "root_slot": 0, "bad_frames": 0}

    # -- frame ingest -------------------------------------------------------

    def handle(self, frame: bytes):
        """Hostile/malformed frames must never crash consensus: bad
        lengths or non-advancing slots are counted and dropped."""
        if not frame:
            self.metrics["bad_frames"] += 1
            return
        if frame[0] == FRAME_BLOCK:
            if len(frame) < 81:
                self.metrics["bad_frames"] += 1
                return
            slot, parent_slot = struct.unpack_from("<QQ", frame, 1)
            block_id = frame[17:49]
            parent_id = frame[49:81]
            if slot <= parent_slot:
                self.metrics["bad_frames"] += 1
                return
            if self.ghost is None:
                # first block anchors the tree at its PARENT (the root
                # the snapshot/genesis handed us)
                self.ghost = Ghost(parent_id, parent_slot,
                                   self.total_stake)
                self.slot_of[parent_id] = parent_slot
            if block_id not in self.ghost.nodes \
                    and parent_id in self.ghost.nodes:
                self.ghost.insert(block_id, slot, parent_id)
                self.slot_of[block_id] = slot
                self.metrics["blocks"] += 1
        elif frame[0] == FRAME_VOTE:
            if len(frame) < 73:
                self.metrics["bad_frames"] += 1
                return
            voter = frame[1:33]
            (stake,) = struct.unpack_from("<Q", frame, 33)
            block_id = frame[41:73]
            if self.ghost is not None:
                self.ghost.replay_vote(voter, stake, block_id)
                self.metrics["votes_in"] += 1
                slot = self.slot_of.get(block_id)
                if slot is not None:
                    ent = self.voter_towers.get(voter)
                    if ent is None:
                        ent = [stake, Tower()]
                        self.voter_towers[voter] = ent
                    ent[0] = stake           # stake may be restated
                    vt: Tower = ent[1]
                    if not vt.votes or slot > vt.votes[-1].slot:
                        vt.vote(slot)
        else:
            self.metrics["bad_frames"] += 1

    # -- decision -----------------------------------------------------------

    def decide(self) -> tuple[int, bytes] | None:
        """Run fork choice + tower checks; returns (slot, block_id) to
        vote for, applying it to our tower, or None."""
        if self.ghost is None:
            return None
        best = self.ghost.best()
        if best == self.ghost.root:
            return None
        slot = self.slot_of.get(best)
        if slot is None:
            return None
        if self.tower.votes and slot <= self.tower.votes[-1].slot:
            return None                   # already voted this deep
        if not self.tower.lockout_check(best, slot, self.ghost,
                                        self.vote_blocks):
            self.metrics["lockout_skips"] += 1
            return None
        if not self.tower.threshold_check(
                slot, [(s, t) for s, t in self.voter_towers.values()],
                self.total_stake):
            self.metrics["threshold_skips"] += 1
            return None
        if self.last_vote_block is not None \
                and self.last_vote_block in self.ghost.nodes \
                and not self.tower.switch_check(best,
                                               self.last_vote_block,
                                               self.ghost):
            self.metrics["switch_skips"] += 1
            return None
        rooted = self.tower.vote(slot)
        self.vote_blocks[slot] = best
        self.last_vote_block = best
        self.metrics["votes_out"] += 1
        if rooted is not None:
            rb = self.vote_blocks.get(rooted)
            if rb is not None and rb in self.ghost.nodes:
                self.ghost.publish(rb)
            # prune slot-indexed state below the root with the ghost
            # (unbounded dicts would leak in a long-running tile)
            self.vote_blocks = {s: b for s, b in self.vote_blocks.items()
                                if s >= rooted}
            self.slot_of = {b: s for b, s in self.slot_of.items()
                            if s >= rooted}
            # voters whose latest vote predates the root have departed
            # (or were spoofed pubkeys from the unauthenticated vote
            # stream) — age them out so the dict and the threshold
            # numerator stay bounded
            self.voter_towers = {
                v: ent for v, ent in self.voter_towers.items()
                if ent[1].votes and ent[1].votes[-1].slot >= rooted}
            self.metrics["roots"] += 1
            self.metrics["root_slot"] = rooted
        return slot, best


class SendCore:
    """Vote egress: vote frame -> vote txn -> keyguard sign -> UDP
    (ref: src/discof/send/; signing via keyguard ROLE_SEND, which
    authorizes txn MESSAGES only)."""

    def __init__(self, identity: bytes, vote_account: bytes,
                 keyguard_client, dest_addr, sock):
        self.identity = identity
        self.vote_account = vote_account
        self.kg = keyguard_client
        self.dest = dest_addr
        self.sock = sock
        self.metrics = {"votes": 0, "sent": 0, "sign_fail": 0}

    def send_vote(self, slot: int, block_id: bytes,
                  lockouts: list[tuple[int, int]] | None = None,
                  root: int | None = None) -> bool:
        """Emit a REAL VoteInstruction::TowerSync transaction (r5 wire
        parity — Agave's current vote form; the tower tile ships its
        full lockout state in the vote frame)."""
        from ..protocol.txn import build_message, build_txn
        from ..svm.vote import VOTE_PROGRAM_ID, ix_tower_sync
        self.metrics["votes"] += 1
        if not lockouts:
            lockouts = [(slot, 1)]
        msg = build_message(
            [self.identity], [self.vote_account, VOTE_PROGRAM_ID],
            block_id,                      # recent blockhash = voted block
            [(2, bytes([1]),
              ix_tower_sync(lockouts, root, block_id, block_id))],
            # the program account is READ-ONLY (reference wire form);
            # writable program ids would serialize all votes through
            # pack's conflict bitsets
            n_ro_unsigned=1)
        sig = self.kg.sign(msg)
        if sig is None:
            self.metrics["sign_fail"] += 1
            return False
        txn = build_txn([sig], msg)
        self.sock.sendto(txn, self.dest)
        self.metrics["sent"] += 1
        return True
