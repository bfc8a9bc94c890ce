"""Native vote program (copy of the JAX package's svm/vote.py; ref: src/flamenco/runtime/program/
fd_vote_program.c — subset: InitializeAccount, Vote, Withdraw; vote
state per src/flamenco/types vote state layout, re-shaped).

The on-chain tower state IS choreo's TowerBFT tower (choreo/tower.py):
a Vote instruction pushes slots through the same expiry/doubling/
rooting rules the consensus layer uses, credits accrue per rooted slot,
and the serialized account state round-trips through a compact struct
layout (not Solana bincode — the layout is this framework's own; the
SEMANTICS follow the reference).

State layout (little-endian):
  node_pubkey 32 | authorized_voter 32 | authorized_withdrawer 32 |
  commission u8 | root_slot u64 (2^64-1 = none) | credits u64 |
  last_ts u64 | vote_cnt u16 | votes: (slot u64 | conf u32)* |
  [optional trailer, r4:] ec_cnt u16 | (epoch u64 | credits u64 |
  prev_credits u64)*  — the epoch-credits history Agave keeps on the
  vote state (ref: fd_vote_program epoch_credits), consumed by the
  epoch-rewards points calculation (flamenco/rewards.py). Absent on
  pre-r4 blobs; from_bytes treats a missing trailer as empty history.
"""
from __future__ import annotations

import struct

from ..choreo.tower import Tower, TowerVote

VOTE_PROGRAM_ID = b"Vote" + bytes(28)
NO_ROOT = (1 << 64) - 1

# Agave VoteInstruction enum discriminants (r5 wire parity; ref
# src/flamenco/runtime/program/fd_vote_program.c instruction decode —
# the subset this program implements)
VOTE_IX_INITIALIZE = 0         # VoteInit {node, voter, withdrawer, u8}
VOTE_IX_AUTHORIZE = 1          # Pubkey + u32 VoteAuthorize kind
VOTE_IX_VOTE = 2               # Vote {slots: Vec<u64>, hash, Opt<i64>}
VOTE_IX_WITHDRAW = 3           # u64 lamports
VOTE_IX_UPDATE_COMMISSION = 5  # u8 commission
VOTE_IX_TOWER_SYNC = 14        # TowerSync {lockouts, root, hash, ts,
                               #            block_id}
AUTH_KIND_VOTER = 0
AUTH_KIND_WITHDRAWER = 1

_HDR = "<32s32s32sBQQQH"
_HDR_SZ = struct.calcsize(_HDR)


class VoteState:
    def __init__(self, node_pubkey: bytes, authorized_voter: bytes,
                 authorized_withdrawer: bytes, commission: int = 0):
        self.node_pubkey = node_pubkey
        self.authorized_voter = authorized_voter
        self.authorized_withdrawer = authorized_withdrawer
        self.commission = commission
        self.tower = Tower()
        self.root_slot: int | None = None
        self.credits = 0
        self.last_ts = 0
        # (epoch, cumulative credits at epoch end, cumulative at the
        # previous epoch's end) — newest LAST, capped at 64 entries
        self.epoch_credits: list[tuple[int, int, int]] = []

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        out = struct.pack(
            _HDR, self.node_pubkey, self.authorized_voter,
            self.authorized_withdrawer, self.commission,
            NO_ROOT if self.root_slot is None else self.root_slot,
            self.credits, self.last_ts, len(self.tower.votes))
        for v in self.tower.votes:
            out += struct.pack("<QI", v.slot, v.conf)
        out += struct.pack("<H", len(self.epoch_credits))
        for ep, cr, prev in self.epoch_credits:
            out += struct.pack("<QQQ", ep, cr, prev)
        return out

    @classmethod
    def from_bytes(cls, b: bytes) -> "VoteState":
        (node, voter, wd, comm, root, credits, ts, cnt) = \
            struct.unpack_from(_HDR, b, 0)
        st = cls(node, voter, wd, comm)
        st.root_slot = None if root == NO_ROOT else root
        st.credits = credits
        st.last_ts = ts
        off = _HDR_SZ
        for _ in range(cnt):
            slot, conf = struct.unpack_from("<QI", b, off)
            st.tower.votes.append(TowerVote(slot, conf))
            off += 12
        st.tower.root = st.root_slot
        if off + 2 <= len(b):            # r4 epoch-credits trailer
            (ec_cnt,) = struct.unpack_from("<H", b, off)
            off += 2
            for _ in range(ec_cnt):
                ep, cr, prev = struct.unpack_from("<QQQ", b, off)
                st.epoch_credits.append((ep, cr, prev))
                off += 24
        return st

    # -- semantics ----------------------------------------------------------

    def _increment_credits(self, epoch: int):
        """Agave vote_state::increment_credits: per-epoch history with
        a 64-entry cap, cumulative + previous-cumulative per entry."""
        if not self.epoch_credits:
            # Agave vote_state::increment_credits seeds the empty
            # history with (epoch, 0, 0) — pre-existing credits must
            # not inflate the first rewarded epoch's earned delta.
            self.epoch_credits.append((epoch, 0, 0))
        elif self.epoch_credits[-1][0] != epoch:
            _, cr, prev = self.epoch_credits[-1]
            if cr != prev:
                self.epoch_credits.append((epoch, cr, cr))
                if len(self.epoch_credits) > 64:
                    self.epoch_credits.pop(0)
            else:
                # the open entry earned nothing: move it to the new
                # epoch in place instead of appending, so empty epochs
                # never consume 64-entry window slots (Agave
                # vote_state::increment_credits "else just move the
                # current epoch" branch — an appending impl diverges
                # from Agave's history for vote accounts with quiet
                # epochs, and the rewards calc reads this window)
                self.epoch_credits[-1] = (epoch, cr, prev)
        self.credits += 1
        ep, cr, prev = self.epoch_credits[-1]
        self.epoch_credits[-1] = (ep, cr + 1, prev)

    def apply_vote(self, slots: list[int], timestamp: int = 0,
                   epoch: int = 0) -> int:
        """Push new vote slots (ascending, > last voted); returns the
        number of newly-rooted slots (credits accrue per root —
        ref: vote credits on root advance; epoch feeds the
        epoch-credits history the rewards calculation reads)."""
        rooted = 0
        last = self.tower.votes[-1].slot if self.tower.votes else -1
        for s in slots:
            if s <= last:
                continue            # stale/duplicate slots are skipped
            r = self.tower.vote(s)
            if r is not None:
                self.root_slot = r
                self._increment_credits(epoch)
                rooted += 1
            last = s
        if timestamp > self.last_ts:
            self.last_ts = timestamp
        return rooted


# -- instruction encoding ----------------------------------------------------

def ix_initialize(node_pubkey: bytes, authorized_voter: bytes,
                  authorized_withdrawer: bytes,
                  commission: int = 0) -> bytes:
    return (struct.pack("<I", VOTE_IX_INITIALIZE) + node_pubkey
            + authorized_voter + authorized_withdrawer
            + bytes([commission]))


def _opt_i64(v: int | None) -> bytes:
    return b"\x00" if v is None else b"\x01" + struct.pack("<q", v)


def ix_vote(slots: list[int], block_hash: bytes = bytes(32),
            timestamp: int | None = None) -> bytes:
    """VoteInstruction::Vote — bincode: u32 disc 2, Vec<u64> slots
    (u64 length), 32-byte hash, Option<i64> timestamp."""
    out = struct.pack("<IQ", VOTE_IX_VOTE, len(slots))
    for s in slots:
        out += struct.pack("<Q", s)
    return out + block_hash + _opt_i64(timestamp)


def ix_tower_sync(lockouts: list[tuple[int, int]], root: int | None,
                  block_hash: bytes, block_id: bytes,
                  timestamp: int | None = None) -> bytes:
    """VoteInstruction::TowerSync — bincode: u32 disc 14, Vec<Lockout>
    {u64 slot, u32 confirmation_count}, Option<u64> root, hash,
    Option<i64> timestamp, block_id."""
    out = struct.pack("<IQ", VOTE_IX_TOWER_SYNC, len(lockouts))
    for slot, conf in lockouts:
        out += struct.pack("<QI", slot, conf)
    out += b"\x00" if root is None else b"\x01" + struct.pack("<Q", root)
    return out + block_hash + _opt_i64(timestamp) + block_id


def ix_withdraw(lamports: int) -> bytes:
    return struct.pack("<IQ", VOTE_IX_WITHDRAW, lamports)


# -- executor hook (called from programs.TxnExecutor) ------------------------

def exec_vote(ic) -> str:
    """ic: programs.InstrCtx — local account indices, invocation-level
    privileges (top-level txn bits, or CPI-validated metas)."""
    from .programs import (
        ERR_BAD_IX_DATA, ERR_INSUFFICIENT, ERR_INVALID_OWNER,
        ERR_MISSING_SIG, ERR_NOT_WRITABLE, OK,
    )
    data = ic.data
    if len(data) < 4:
        return ERR_BAD_IX_DATA
    disc = struct.unpack_from("<I", data, 0)[0]
    if ic.n < 1:
        return ERR_BAD_IX_DATA
    acct = ic.account(0)

    if disc == VOTE_IX_INITIALIZE:
        if len(data) < 4 + 96 + 1:
            return ERR_BAD_IX_DATA
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if acct.owner != VOTE_PROGRAM_ID or acct.data.strip(b"\x00"):
            return ERR_INVALID_OWNER      # must be fresh + vote-owned
        # the NODE identity must sign initialization, or anyone could
        # hijack a freshly-created vote account by installing their own
        # authorities (ref: vote program InitializeAccount requires the
        # node pubkey signature)
        node = data[4:36]
        if node not in ic.signer_keys():
            return ERR_MISSING_SIG
        st = VoteState(node, data[36:68], data[68:100], data[100])
        acct.data = st.to_bytes()
        return OK

    if acct.owner != VOTE_PROGRAM_ID or len(acct.data) < _HDR_SZ:
        return ERR_INVALID_OWNER
    st = VoteState.from_bytes(acct.data)

    if disc in (VOTE_IX_VOTE, VOTE_IX_TOWER_SYNC):
        # bincode layouts (Agave VoteInstruction::Vote / ::TowerSync)
        try:
            off = 4
            (cnt,) = struct.unpack_from("<Q", data, off)
            off += 8
            if cnt == 0 or cnt > 64:
                return ERR_BAD_IX_DATA
            slots = []
            for _ in range(cnt):
                (s,) = struct.unpack_from("<Q", data, off)
                slots.append(s)
                off += 8 if disc == VOTE_IX_VOTE else 12  # + u32 conf
            if disc == VOTE_IX_TOWER_SYNC:
                if data[off]:                 # Option<u64> root
                    off += 9
                else:
                    off += 1
            off += 32                         # bank hash
            ts = None
            if data[off]:                     # Option<i64> timestamp
                (ts,) = struct.unpack_from("<q", data, off + 1)
                off += 9
            else:
                off += 1
            if disc == VOTE_IX_TOWER_SYNC:
                off += 32                     # block_id
            if off > len(data):
                return ERR_BAD_IX_DATA
        except (struct.error, IndexError):
            return ERR_BAD_IX_DATA
        # the AUTHORIZED VOTER must sign (ref: vote program authority
        # checks), not merely the vote account
        if st.authorized_voter not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        st.apply_vote(sorted(slots), ts or 0, epoch=ic.ctx.epoch)
        acct.data = st.to_bytes()
        return OK

    if disc == VOTE_IX_AUTHORIZE:
        if len(data) < 40:
            return ERR_BAD_IX_DATA
        new_auth = data[4:36]
        kind = struct.unpack_from("<I", data, 36)[0]
        # the CURRENT authority of that kind must sign (ref: vote
        # program authorize — voter changes need the voter OR the
        # withdrawer; withdrawer changes need the withdrawer)
        signers = ic.signer_keys()
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if kind == AUTH_KIND_VOTER:
            if st.authorized_voter not in signers \
                    and st.authorized_withdrawer not in signers:
                return ERR_MISSING_SIG
            st.authorized_voter = new_auth
        elif kind == AUTH_KIND_WITHDRAWER:
            if st.authorized_withdrawer not in signers:
                return ERR_MISSING_SIG
            st.authorized_withdrawer = new_auth
        else:
            return ERR_BAD_IX_DATA
        acct.data = st.to_bytes()
        return OK

    if disc == VOTE_IX_UPDATE_COMMISSION:
        if len(data) < 5:
            return ERR_BAD_IX_DATA
        if st.authorized_withdrawer not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        st.commission = data[4]
        acct.data = st.to_bytes()
        return OK

    if disc == VOTE_IX_WITHDRAW:
        if len(data) < 12 or ic.n < 2:
            return ERR_BAD_IX_DATA
        lamports = struct.unpack_from("<Q", data, 4)[0]
        if st.authorized_withdrawer not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        if lamports > acct.lamports:
            return ERR_INSUFFICIENT
        acct.lamports -= lamports
        ic.account(1).lamports += lamports
        return OK

    return ERR_BAD_IX_DATA
