"""Native stake program: delegation lifecycle feeding consensus stake
(copy of the JAX package's svm/stake.py).

Subset of the reference's stake program re-expressed for this runtime
(ref: src/flamenco/runtime/program/fd_stake_program.c — Initialize /
DelegateStake / Deactivate / Withdraw with the authorized-staker/
withdrawer split; epoch-boundary activation semantics per the stake
history discipline). Activation runs in TWO modes: with a
StakeHistory sysvar present, the reference's RATE-LIMITED
warmup/cooldown (at most WARMUP_COOLDOWN_RATE x the prior epoch's
cluster-effective stake moves per epoch, pro-rata —
stake_activating_and_deactivating below, r5); without one, step
activation (a delegation made in epoch E is ACTIVE for epochs > E, a
deactivation in epoch E stops counting for epochs > E) for
self-contained clusters and unit tests.

The current epoch reaches the program through TxnContext.epoch — this
framework's stand-in for the Clock sysvar (the reference reads
fd_sysvar_clock).

State layout (compact struct, this framework's own; semantics follow
the reference):
  u8 state (0 uninitialized | 1 initialized | 2 delegated)
  staker 32 | withdrawer 32 | rent_reserve u64
  voter 32 | amount u64 | activation_epoch u64 | deactivation_epoch u64
"""
from __future__ import annotations

import struct

STAKE_PROGRAM_ID = b"Stake" + bytes(27)
EPOCH_NONE = (1 << 64) - 1

STAKE_IX_INITIALIZE = 0
STAKE_IX_DELEGATE = 1
STAKE_IX_DEACTIVATE = 2
STAKE_IX_WITHDRAW = 3

_FMT = "<B32s32sQ32sQQQ"
STATE_SZ = struct.calcsize(_FMT)

ST_UNINIT, ST_INIT, ST_DELEGATED = 0, 1, 2


class StakeState:
    def __init__(self, state=ST_UNINIT, staker=bytes(32),
                 withdrawer=bytes(32), rent_reserve=0, voter=bytes(32),
                 amount=0, activation_epoch=EPOCH_NONE,
                 deactivation_epoch=EPOCH_NONE):
        self.state = state
        self.staker = staker
        self.withdrawer = withdrawer
        self.rent_reserve = rent_reserve
        self.voter = voter
        self.amount = amount
        self.activation_epoch = activation_epoch
        self.deactivation_epoch = deactivation_epoch

    def to_bytes(self) -> bytes:
        return struct.pack(_FMT, self.state, self.staker,
                           self.withdrawer, self.rent_reserve,
                           self.voter, self.amount,
                           self.activation_epoch,
                           self.deactivation_epoch)

    @classmethod
    def from_bytes(cls, b: bytes) -> "StakeState":
        return cls(*struct.unpack_from(_FMT, b, 0))

    # -- epoch semantics ----------------------------------------------------

    def active_at(self, epoch: int, history: dict | None = None,
                  rate: float | None = None) -> int:
        """Stake counted for `epoch`.

        Without `history`: step activation (active strictly after the
        activation epoch, through the deactivation epoch) — the
        self-contained-cluster mode.

        With `history` (epoch -> (effective, activating, deactivating)
        cluster totals, the StakeHistory sysvar): the reference's
        RATE-LIMITED warmup/cooldown — at most rate x the prior
        epoch's cluster-effective stake (de)activates per epoch,
        apportioned pro-rata across waiting delegations (ref:
        src/flamenco/runtime/program/fd_stake_program.c stake history
        discipline; Agave stake_activating_and_deactivating)."""
        if history is not None:
            eff, _act, _deact = stake_activating_and_deactivating(
                self, epoch, history,
                rate if rate is not None else WARMUP_COOLDOWN_RATE)
            return eff
        if self.state != ST_DELEGATED:
            return 0
        if self.activation_epoch == EPOCH_NONE \
                or epoch <= self.activation_epoch:
            return 0
        if self.deactivation_epoch != EPOCH_NONE \
                and epoch > self.deactivation_epoch:
            return 0
        return self.amount

    def fully_inactive(self, epoch: int) -> bool:
        if self.state != ST_DELEGATED:
            return True
        if self.activation_epoch == EPOCH_NONE:
            return True
        return (self.deactivation_epoch != EPOCH_NONE
                and epoch > self.deactivation_epoch)


# post reduce_stake_warmup_cooldown rate (9%/epoch of cluster
# effective stake; 25% before the feature)
WARMUP_COOLDOWN_RATE = 0.09


def _stake_and_activating(amount: int, activation_epoch: int,
                          target_epoch: int, history: dict,
                          rate: float) -> tuple[int, int]:
    """(effective, activating) at target_epoch. Float weights mirror
    Agave's f64 arithmetic exactly (consensus-visible there too)."""
    if activation_epoch == EPOCH_NONE:
        return amount, 0               # bootstrap: effective at genesis
    if target_epoch < activation_epoch:
        return 0, 0
    if target_epoch == activation_epoch:
        return 0, amount
    prev = history.get(activation_epoch)
    if prev is None:
        return amount, 0               # no history entry: fully active
    prev_epoch = activation_epoch
    current = 0
    while True:
        current_epoch = prev_epoch + 1
        remaining = amount - current
        prev_eff, prev_act, _ = prev
        if prev_act == 0:
            break
        weight = remaining / prev_act
        newly_cluster = prev_eff * rate
        newly = max(1, int(weight * newly_cluster))
        current += newly
        if current >= amount:
            return amount, 0
        if current_epoch >= target_epoch:
            break
        prev = history.get(current_epoch)
        if prev is None:
            break
        prev_epoch = current_epoch
    return current, amount - current


def stake_activating_and_deactivating(st: "StakeState",
                                      target_epoch: int,
                                      history: dict,
                                      rate: float = WARMUP_COOLDOWN_RATE
                                      ) -> tuple[int, int, int]:
    """(effective, activating, deactivating) for one delegation under
    the cluster stake history — Agave
    Delegation::stake_activating_and_deactivating, draw-compatible
    including the max(1,...) per-epoch floor and the f64 weights."""
    if st.state != ST_DELEGATED:
        return 0, 0, 0
    eff, act = _stake_and_activating(st.amount, st.activation_epoch,
                                     target_epoch, history, rate)
    de = st.deactivation_epoch
    if target_epoch < de or de == EPOCH_NONE:
        return eff, act, 0
    if target_epoch == de:
        return eff, 0, eff             # all effective stake cooling
    # cooldown from the deactivation epoch's effective amount
    eff_at_de, _ = _stake_and_activating(st.amount, st.activation_epoch,
                                         de, history, rate)
    prev = history.get(de)
    if prev is None:
        return 0, 0, 0                 # no history: instant cooldown
    prev_epoch = de
    current = eff_at_de
    while True:
        current_epoch = prev_epoch + 1
        _, _, prev_deact = prev
        prev_eff = prev[0]
        if prev_deact == 0:
            break
        weight = current / prev_deact
        newly_not = max(1, int(weight * (prev_eff * rate)))
        current -= newly_not
        if current <= 0:
            return 0, 0, 0
        if current_epoch >= target_epoch:
            break
        prev = history.get(current_epoch)
        if prev is None:
            break
        prev_epoch = current_epoch
    return current, 0, current


def _read_history(ic) -> dict | None:
    """StakeHistory sysvar via the instruction's txn context (None
    when the account doesn't exist — step-activation mode)."""
    from .sysvars import STAKE_HISTORY_ID, stake_history_from_account
    return stake_history_from_account(
        ic.ctx.db.peek(ic.ctx.xid, STAKE_HISTORY_ID))


def ix_initialize(staker: bytes, withdrawer: bytes) -> bytes:
    return struct.pack("<I", STAKE_IX_INITIALIZE) + staker + withdrawer


def ix_delegate() -> bytes:
    return struct.pack("<I", STAKE_IX_DELEGATE)


def ix_deactivate() -> bytes:
    return struct.pack("<I", STAKE_IX_DEACTIVATE)


def ix_withdraw(lamports: int) -> bytes:
    return struct.pack("<IQ", STAKE_IX_WITHDRAW, lamports)


def exec_stake(ic) -> str:
    """ic: programs.InstrCtx. Dispatched from the executor's native
    program switch."""
    from .programs import (
        ERR_BAD_IX_DATA, ERR_INSUFFICIENT, ERR_INVALID_OWNER,
        ERR_MISSING_SIG, ERR_NOT_WRITABLE, ERR_UNKNOWN_IX, OK,
    )
    from .vote import VOTE_PROGRAM_ID
    data = ic.data
    if len(data) < 4 or ic.n < 1:
        return ERR_BAD_IX_DATA
    disc = struct.unpack_from("<I", data, 0)[0]
    acct = ic.account(0)
    if acct.owner != STAKE_PROGRAM_ID:
        return ERR_INVALID_OWNER
    epoch = ic.ctx.epoch

    if disc == STAKE_IX_INITIALIZE:
        if len(data) < 4 + 64:
            return ERR_BAD_IX_DATA
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if acct.data and any(acct.data[:1]):
            return ERR_INVALID_OWNER         # already initialized
        # the rent-exempt reserve is locked at initialize and never
        # delegated or withdrawable while the account lives (ref
        # fd_stake_program.c initialize: requires the rent minimum)
        from .sysvars import rent_exempt_minimum
        reserve = rent_exempt_minimum(STATE_SZ)
        if acct.lamports < reserve:
            return ERR_INSUFFICIENT
        st = StakeState(ST_INIT, staker=data[4:36],
                        withdrawer=data[36:68], rent_reserve=reserve)
        acct.data = st.to_bytes()
        return OK

    if len(acct.data) < STATE_SZ:
        return ERR_INVALID_OWNER
    st = StakeState.from_bytes(acct.data)

    if disc == STAKE_IX_DELEGATE:
        if ic.n < 2:
            return ERR_BAD_IX_DATA
        if st.state == ST_UNINIT:
            return ERR_INVALID_OWNER
        if st.staker not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        vote_acct = ic.account(1)
        if vote_acct.owner != VOTE_PROGRAM_ID:
            return ERR_INVALID_OWNER
        if st.state == ST_DELEGATED and not st.fully_inactive(epoch):
            # re-delegation of live stake is refused (the reference
            # allows it only through the deactivate-then-delegate path)
            return ERR_INVALID_OWNER
        amount = acct.lamports - st.rent_reserve
        if amount <= 0:
            return ERR_INSUFFICIENT
        st.state = ST_DELEGATED
        st.voter = ic.key(1)
        st.amount = amount
        st.activation_epoch = epoch
        st.deactivation_epoch = EPOCH_NONE
        acct.data = st.to_bytes()
        return OK

    if disc == STAKE_IX_DEACTIVATE:
        if st.state != ST_DELEGATED or st.deactivation_epoch != EPOCH_NONE:
            return ERR_INVALID_OWNER
        if st.staker not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        st.deactivation_epoch = epoch
        acct.data = st.to_bytes()
        return OK

    if disc == STAKE_IX_WITHDRAW:
        if len(data) < 12 or ic.n < 2:
            return ERR_BAD_IX_DATA
        lamports = struct.unpack_from("<Q", data, 4)[0]
        if st.withdrawer not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        hist = _read_history(ic)
        if hist:
            # rate-limited cooldown: lamports stay locked while the
            # stake history still counts them as effective (ref
            # fd_stake_program.c withdraw: staked = delegation stake
            # at the clock epoch under the history)
            eff, act, _ = stake_activating_and_deactivating(
                st, epoch, hist)
            staked = eff + act
        else:
            staked = 0 if st.fully_inactive(epoch) else st.amount
        if staked:
            locked = staked + st.rent_reserve
        elif lamports == acct.lamports:
            locked = 0            # full drain closes the account
        else:
            # Agave withdraw: a NON-closing withdraw must keep the
            # rent-exempt reserve funded even with nothing staked
            # (lamports + reserve <= balance)
            locked = st.rent_reserve
        if lamports > acct.lamports - locked:
            return ERR_INSUFFICIENT
        acct.lamports -= lamports
        ic.account(1).lamports += lamports
        return OK

    return ERR_UNKNOWN_IX
