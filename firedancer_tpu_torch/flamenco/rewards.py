"""Partitioned epoch rewards: inflation -> stake/vote payouts (copy of
the JAX package's flamenco/rewards.py).

Re-expression of the reference's rewards pipeline
(ref: src/flamenco/rewards/fd_rewards.c — calculate_inflation_rates,
calculate_stake_points_and_credits, the partitioned distribution of
SIMD-0118 mirrored in fd_rewards.c's epoch_rewards partitions):

  1. The inflation schedule (initial 8%/yr tapering 15%/yr to a 1.5%
     terminal rate) fixes the epoch's total validator issuance from
     the capitalization and the epoch's fraction of a year.
  2. Each stake delegation earns POINTS = active_stake × credits its
     vote account earned THAT epoch (the epoch_credits history on the
     vote state). Lamports pro-rate by points; the vote account's
     commission takes its cut, the remainder COMPOUNDS into the
     delegation.
  3. Distribution is partitioned: payouts are hash-assigned to
     `num_partitions` buckets credited one per slot at the start of
     the next epoch, bounding per-block write load.

All arithmetic is integer (floor division at each step — consensus
code must not float); the only float is the published inflation RATE,
converted to lamports via a fixed-point basis-points product.
"""
from __future__ import annotations

import hashlib
import struct

from ..funk.funk import key32
from ..svm.accdb import Account
from ..svm.stake import STAKE_PROGRAM_ID, StakeState
from ..svm.vote import VOTE_PROGRAM_ID, VoteState, _HDR_SZ

SLOT_SECONDS = 0.4
YEAR_SECONDS = 31_557_600       # Julian year: 365.25 * 24 * 3600

INITIAL_RATE_BPS = 800          # 8.00 %/yr
TAPER_BPS = 1500                # 15 % of itself per year
TERMINAL_RATE_BPS = 150         # 1.50 %/yr

MAX_ACCOUNTS_PER_PARTITION = 4096


def inflation_rate_bps(epoch: int, slots_per_epoch: int) -> int:
    """Validator inflation rate (basis points/yr) in effect at
    `epoch`: initial·(1−taper)^years, floored at terminal. Computed in
    integer bps with per-year taper multiplication so every validator
    lands on the identical value."""
    # exact integer ratio (slots·0.4s vs 31557600s/yr → ×4 // ×10·year)
    years = (epoch * slots_per_epoch * 4) // (10 * YEAR_SECONDS)
    rate = INITIAL_RATE_BPS
    for _ in range(years):
        rate = rate * (10_000 - TAPER_BPS) // 10_000
        if rate <= TERMINAL_RATE_BPS:
            return TERMINAL_RATE_BPS
    return max(rate, TERMINAL_RATE_BPS)


def epoch_validator_issuance(capitalization: int, epoch: int,
                             slots_per_epoch: int) -> int:
    """Lamports to mint for `epoch`: cap × rate × epoch_year_fraction.
    The year fraction is (slots·SLOT_SECONDS)/year expressed as an
    exact integer ratio (slots·4, year·10) to avoid floats."""
    rate = inflation_rate_bps(epoch, slots_per_epoch)
    num = capitalization * rate * slots_per_epoch * 4
    den = 10_000 * YEAR_SECONDS * 10
    return num // den


def calculate_stake_rewards(funk, xid, rewarded_epoch: int,
                            issuance: int, items: dict | None = None):
    """Point totals + per-account payouts for `rewarded_epoch`.

    Returns (rewards, total_points) where rewards is a list of
    (stake_pubkey, stake_delta, vote_pubkey, vote_delta) with deltas
    in lamports. Stake accounts whose voter earned no credits that
    epoch earn nothing (ref: calculate_stake_points_and_credits
    skipping zero-credit epochs)."""
    if items is None:
        # one overlay fold serves both scans (items_at re-folds the
        # whole fork per call)
        items = funk.items_at(xid)
    credits_by_vote: dict[bytes, int] = {}
    commission_by_vote: dict[bytes, int] = {}
    for key, acct in items.items():
        if not isinstance(acct, Account) \
                or acct.owner != VOTE_PROGRAM_ID \
                or len(acct.data) < _HDR_SZ:
            continue
        try:
            vs = VoteState.from_bytes(acct.data)
        except Exception:
            continue
        earned = 0
        for ep, cr, prev in vs.epoch_credits:
            if ep == rewarded_epoch:
                earned = cr - prev
                break
        if earned > 0:
            credits_by_vote[key] = earned
            commission_by_vote[key] = vs.commission

    # rewards and vote_stakes/leader schedule must count the SAME
    # stake: apply the rate-limited history when the sysvar exists
    from .stakes import read_stake_history
    history = read_stake_history(funk, xid)
    entries = []                 # (stake_key, points, vote_key)
    total_points = 0
    for key, acct in items.items():
        if not isinstance(acct, Account) \
                or acct.owner != STAKE_PROGRAM_ID:
            continue
        try:
            st = StakeState.from_bytes(acct.data)
        except Exception:
            continue
        stake = st.active_at(rewarded_epoch, history=history or None)
        credits = credits_by_vote.get(st.voter, 0)
        pts = stake * credits
        if pts > 0:
            entries.append((key, pts, st.voter))
            total_points += pts

    rewards = []
    if total_points == 0:
        return rewards, 0
    for key, pts, voter in entries:
        amount = issuance * pts // total_points
        commission = commission_by_vote.get(voter, 0)
        vote_delta = amount * commission // 100
        stake_delta = amount - vote_delta
        rewards.append((key, stake_delta, voter, vote_delta))
    return rewards, total_points


def num_partitions(n_rewards: int) -> int:
    return max(1, -(-n_rewards // MAX_ACCOUNTS_PER_PARTITION))


def partition_of(stake_pubkey: bytes, parent_blockhash: bytes,
                 parts: int) -> int:
    """Deterministic hash partition (the reference seeds its
    SipHash-based partitioner with the parent blockhash; we use
    sha256(parent_blockhash ‖ pubkey) — internal determinism, same
    load-spreading role)."""
    h = hashlib.sha256(parent_blockhash + stake_pubkey).digest()
    return struct.unpack_from("<Q", h, 0)[0] % parts


def apply_rewards_partition(funk, xid, rewards, parent_blockhash: bytes,
                            parts: int, partition: int) -> int:
    """Credit one partition's payouts (the per-slot duty at the start
    of the new epoch). Stake deltas COMPOUND into the delegation
    amount; vote deltas are plain lamport credits. Returns lamports
    distributed."""
    paid = 0
    for stake_key, stake_delta, vote_key, vote_delta in rewards:
        if partition_of(stake_key, parent_blockhash, parts) != partition:
            continue
        acct = funk.rec_query(xid, stake_key)
        if isinstance(acct, Account):
            st = StakeState.from_bytes(acct.data)
            st.amount += stake_delta
            na = Account(acct.lamports + stake_delta,
                         bytearray(st.to_bytes()), acct.owner,
                         acct.executable, acct.rent_epoch)
            funk.rec_write(xid, key32(stake_key), na)
            paid += stake_delta
        if vote_delta:
            va = funk.rec_query(xid, vote_key)
            if isinstance(va, Account):
                nv = Account(va.lamports + vote_delta, va.data,
                             va.owner, va.executable, va.rent_epoch)
                funk.rec_write(xid, key32(vote_key), nv)
                paid += vote_delta
    return paid


def distribute_epoch_rewards(funk, xid, rewarded_epoch: int,
                             capitalization: int | None,
                             slots_per_epoch: int,
                             parent_blockhash: bytes) -> dict:
    """Whole-epoch convenience: compute + pay every partition (callers
    that stage per-slot call apply_rewards_partition themselves).
    capitalization=None derives it from the same single overlay fold
    the points calculation uses. Returns a summary dict."""
    items = funk.items_at(xid)
    if capitalization is None:
        capitalization = sum(a.lamports for a in items.values()
                             if isinstance(a, Account))
    issuance = epoch_validator_issuance(capitalization, rewarded_epoch,
                                        slots_per_epoch)
    rewards, points = calculate_stake_rewards(funk, xid, rewarded_epoch,
                                              issuance, items=items)
    parts = num_partitions(len(rewards))
    paid = 0
    for p in range(parts):
        paid += apply_rewards_partition(funk, xid, rewards,
                                        parent_blockhash, parts, p)
    return {"issuance": issuance, "paid": paid, "points": points,
            "accounts": len(rewards), "partitions": parts}


# -- paid-through marker ------------------------------------------------------
# Restart discipline: the highest epoch whose rewards have been paid
# lives in a marker ACCOUNT, so it rides snapshots/checkpoints and a
# rebooted bank neither re-pays (supply inflation) nor skips epochs.
# Internal reserved address (not a Solana one).

REWARDS_MARKER_KEY = b"FdtpuEpochRewardsPaidThrough\x00\x00\x00\x00"


def paid_through(funk, xid) -> int:
    acct = funk.rec_query(xid, REWARDS_MARKER_KEY)
    if isinstance(acct, Account) and len(acct.data) >= 8:
        return struct.unpack_from("<Q", bytes(acct.data[:8]), 0)[0]
    return 0


def mark_paid_through(funk, xid, epoch: int):
    funk.rec_write(xid, REWARDS_MARKER_KEY,
                   Account(0, bytearray(struct.pack("<Q", epoch)),
                           b"\x00" * 32))
