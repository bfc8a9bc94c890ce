"""Epoch stakes: aggregate delegations -> consensus weights (copy of
the JAX package's flamenco/stakes.py).

The reference computes per-epoch stake weights from the stake
delegations the runtime landed, keyed to vote accounts, then to node
identities for the leader schedule and turbine tree
(ref: src/flamenco/runtime/sysvar/fd_sysvar_stake_history.c usage in
fd_stakes.c — refresh_vote_accounts / stake delegations iteration;
leader schedule input src/flamenco/leaders/fd_leaders.c:112).

This module walks the funk fork (overlay scan: nearest-ancestor record
wins, same visibility rule as funk.rec_query), filters stake-program
accounts, applies the epoch activation window (svm/stake.py
StakeState.active_at), and returns:

  vote_stakes(...)  vote-account pubkey -> active stake
  node_stakes(...)  node identity      -> active stake (via the vote
                    account's node_pubkey)

Feed node_stakes into EpochLeaders (leader schedule), ShredDest
(turbine weights), and the tower's total_stake — one stake source for
all three, the way the reference plumbs epoch stakes everywhere.
"""
from __future__ import annotations

from ..svm.accdb import Account
from ..svm.stake import STAKE_PROGRAM_ID, StakeState
from ..svm.vote import VOTE_PROGRAM_ID, VoteState, _HDR_SZ


def _delegations(funk, xid):
    for key, acct in funk.items_at(xid).items():
        if not isinstance(acct, Account) \
                or acct.owner != STAKE_PROGRAM_ID:
            continue
        try:
            yield key, StakeState.from_bytes(acct.data)
        except Exception:
            continue


def read_stake_history(funk, xid) -> dict | None:
    """StakeHistory sysvar -> {epoch: (effective, activating,
    deactivating)}, or None when the account doesn't exist (tests /
    self-contained clusters run step activation)."""
    from ..svm.sysvars import (STAKE_HISTORY_ID,
                               stake_history_from_account)
    acct = funk.rec_query(xid, STAKE_HISTORY_ID) \
        if hasattr(funk, "rec_query") else None
    return stake_history_from_account(
        acct if isinstance(acct, Account) else None)


def cluster_stake_totals(funk, xid, epoch: int,
                         history: dict) -> tuple[int, int, int]:
    """(effective, activating, deactivating) cluster totals at `epoch`
    given the history through epoch-1 — the entry the bank appends to
    the StakeHistory sysvar at each boundary (ref:
    src/flamenco/runtime/sysvar/fd_sysvar_stake_history.c update)."""
    from ..svm.stake import stake_activating_and_deactivating
    te = ta = td = 0
    for _, st in _delegations(funk, xid):
        e, a, d = stake_activating_and_deactivating(st, epoch, history)
        te += e
        ta += a
        td += d
    return te, ta, td


def update_stake_history(funk, xid, epoch: int):
    """Epoch-boundary duty: append `epoch`'s cluster totals to the
    StakeHistory sysvar (newest first)."""
    from ..svm.sysvars import (STAKE_HISTORY_ID, _write,
                               dec_stake_history, enc_stake_history)
    prev = funk.rec_query(xid, STAKE_HISTORY_ID)
    hist = {}
    if isinstance(prev, Account) and len(prev.data) >= 8:
        try:
            hist = dec_stake_history(bytes(prev.data))
        except Exception:
            hist = {}
    totals = cluster_stake_totals(funk, xid, epoch, hist)
    entries = [(epoch, totals)] + sorted(
        ((e, t) for e, t in hist.items() if e != epoch),
        key=lambda kv: -kv[0])
    _write(funk, xid, STAKE_HISTORY_ID, enc_stake_history(entries))
    return totals


def vote_stakes(funk, xid, epoch: int,
                history: dict | None = None) -> dict[bytes, int]:
    """history=None reads the StakeHistory sysvar if present; pass {}
    to force step activation."""
    if history is None:
        history = read_stake_history(funk, xid)
    out: dict[bytes, int] = {}
    for _, st in _delegations(funk, xid):
        amt = st.active_at(epoch, history=history or None)
        if amt > 0:
            out[st.voter] = out.get(st.voter, 0) + amt
    return out


def node_stakes(funk, xid, epoch: int) -> dict[bytes, int]:
    """Active stake per node identity: stake -> vote account ->
    node_pubkey (zero for vote accounts that don't resolve)."""
    per_vote = vote_stakes(funk, xid, epoch)
    out: dict[bytes, int] = {}
    for vote_key, amt in per_vote.items():
        va = funk.rec_query(xid, vote_key)
        if not isinstance(va, Account) or va.owner != VOTE_PROGRAM_ID \
                or len(va.data) < _HDR_SZ:
            continue
        node = VoteState.from_bytes(va.data).node_pubkey
        out[node] = out.get(node, 0) + amt
    return out


def total_stake(funk, xid, epoch: int) -> int:
    return sum(vote_stakes(funk, xid, epoch).values())
