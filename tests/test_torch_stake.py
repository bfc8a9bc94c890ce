"""The port's stake program and epoch stakes (firedancer_tpu_torch/svm/
stake.py, flamenco/stakes.py) against the JAX package's: the cases of
tests/test_stake.py, each run through both packages' executors on the
same accounts with equal statuses, fees, logs and byte-equal accounts
(tests/torch_svm_parity.Both); the rate-limited warmup and cooldown, and
the StakeHistory sysvar's update on both."""
import struct

import pytest

from torch_svm_parity import JAX, PKGS, TORCH, Both, k, txn

PAYER = k(1)
S1, S2, S3 = k(0x11), k(0x12), k(0x13)
V1, V2 = k(0x21), k(0x22)
N1, N2 = k(0x31), k(0x32)
DEST = k(0x41)
STAKE, SYS = TORCH.stake.STAKE_PROGRAM_ID, bytes(32)
NONE = TORCH.stake.EPOCH_NONE


@pytest.fixture
def b():
    accts = {PAYER: 1 << 40, DEST: 1 << 20}
    for v, n in ((V1, N1), (V2, N2)):
        accts[v] = dict(lamports=1, owner=TORCH.vote.VOTE_PROGRAM_ID,
                        data=TORCH.vote.VoteState(n, PAYER,
                                                  PAYER).to_bytes())
    return Both(accts)


def _mk_stake(b, key, lamports):
    sz = TORCH.stake.STATE_SZ
    create = struct.pack("<IQQ", 0, lamports
                         + TORCH.sysvars.rent_exempt_minimum(sz),
                         sz) + STAKE
    assert b.run(txn([PAYER, key], [SYS], [(2, [0, 1], create)])) == "ok"
    assert b.run(txn([PAYER], [key, STAKE],
                     [(2, [1], TORCH.stake.ix_initialize(PAYER, PAYER))],
                     n_ro_unsigned=1)) == "ok"


def _delegate(b, key, vote, signer=PAYER):
    return b.run(txn([signer], [key, vote, STAKE],
                     [(3, [1, 2], TORCH.stake.ix_delegate())],
                     n_ro_unsigned=2))


def _deactivate(b, key):
    return b.run(txn([PAYER], [key, STAKE],
                     [(2, [1], TORCH.stake.ix_deactivate())],
                     n_ro_unsigned=1))


def _withdraw(b, key, amount):
    return b.run(txn([PAYER], [key, DEST, STAKE],
                     [(3, [1, 2], TORCH.stake.ix_withdraw(amount))],
                     n_ro_unsigned=1))


def _stakes(epoch):
    return lambda pkg, funk: (pkg.stakes.vote_stakes(funk, "blk", epoch),
                              pkg.stakes.node_stakes(funk, "blk", epoch),
                              pkg.stakes.total_stake(funk, "blk", epoch))


def test_instruction_data_and_state_match_reference():
    for name, args in (("ix_initialize", (k(1), k(2))),
                       ("ix_delegate", ()), ("ix_deactivate", ()),
                       ("ix_withdraw", (77,))):
        assert getattr(TORCH.stake, name)(*args) == \
            getattr(JAX.stake, name)(*args)
    assert TORCH.stake.STAKE_PROGRAM_ID == JAX.stake.STAKE_PROGRAM_ID
    st = [p.stake.StakeState(2, k(1), k(2), 5, k(3), 6, 7, 8)
          for p in PKGS]
    assert st[1].to_bytes() == st[0].to_bytes()


def test_delegation_lifecycle_and_epoch_window(b):
    _mk_stake(b, S1, 1000)
    assert _delegate(b, S1, V1) == "ok"
    st = TORCH.stake.StakeState.from_bytes(b.account(S1).data)
    assert st.voter == V1 and st.amount == 1000
    assert (st.active_at(0), st.active_at(1)) == (0, 1000)
    assert b.call(_stakes(1)) == ({V1: 1000}, {N1: 1000}, 1000)
    assert _delegate(b, S1, V2) == "invalid_account_owner"
    assert _withdraw(b, S1, 500) == "insufficient_funds"
    b.set(epoch=1)
    assert _deactivate(b, S1) == "ok"
    assert _deactivate(b, S1) == "invalid_account_owner"
    b.set(epoch=2)
    assert _withdraw(b, S1, 1000) == "ok"
    assert b.account(DEST).lamports == (1 << 20) + 1000


def test_unauthorized_staker_refused(b):
    _mk_stake(b, S1, 1000)
    evil = k(0x66)
    b.write(evil, lamports=1 << 30)
    assert _delegate(b, S1, V1, signer=evil) == \
        "missing_required_signature"


def test_delegation_change_moves_epoch_stakes(b):
    _mk_stake(b, S1, 10_000)
    _mk_stake(b, S2, 1_000)
    assert _delegate(b, S1, V1) == _delegate(b, S2, V2) == "ok"
    assert b.call(_stakes(1))[1] == {N1: 10_000, N2: 1_000}
    b.set(epoch=1)
    assert _deactivate(b, S1) == "ok"
    _mk_stake(b, S3, 100_000)
    assert _delegate(b, S3, V2) == "ok"
    assert b.call(_stakes(2))[1:] == ({N2: 101_000}, 101_000)


def test_withdraw_under_stake_history(b):
    """With the StakeHistory sysvar present, withdraw locks what the
    rate-limited history still counts as effective: with no effective
    stake in the cluster the delegation warms up at the floor of one
    lamport an epoch, and cools down the same way."""
    _mk_stake(b, S1, 50_000)
    assert _delegate(b, S1, V1) == "ok"
    for e in range(3):
        b.call(lambda pkg, funk, e=e: pkg.stakes.update_stake_history(
            funk, "blk", e))
        b.set(epoch=e + 1)
    assert _deactivate(b, S1) == "ok"
    assert _withdraw(b, S1, 50_000) == "insufficient_funds"
    assert _withdraw(b, S1, 49_000) == "ok"
    for e in range(3, 9):
        b.call(lambda pkg, funk, e=e: pkg.stakes.update_stake_history(
            funk, "blk", e))
    b.set(epoch=9)
    assert _withdraw(b, S1, 1_000) == "ok"


@pytest.mark.parametrize("amount,act,deact,hist,epochs", [
    (500_000, 10, NONE, {10: (1_000_000, 1_000_000, 0),
                         11: (1_090_000, 910_000, 0),
                         12: (1_188_100, 811_900, 0)}, range(8, 15)),
    (400_000, NONE, 5, {5: (1_000_000, 0, 800_000),
                        6: (920_000, 0, 720_000)}, range(3, 9)),
    (1000, 0, 3, {}, range(0, 5))])
def test_warmup_and_cooldown_match_reference(amount, act, deact, hist,
                                             epochs):
    got = []
    for p in PKGS:
        st = p.stake.StakeState(state=p.stake.ST_DELEGATED, amount=amount,
                                activation_epoch=act,
                                deactivation_epoch=deact)
        got.append([(p.stake.stake_activating_and_deactivating(
            st, e, hist), st.active_at(e), st.active_at(e, history=hist),
            st.fully_inactive(e)) for e in epochs])
    assert got[1] == got[0]


def test_stake_history_sysvar_update(b):
    _mk_stake(b, S1, 7_000)
    assert _delegate(b, S1, V1) == "ok"
    for e in (3, 4):
        assert b.call(lambda pkg, funk, e=e: pkg.stakes
                      .update_stake_history(funk, "blk", e)) is not None
    hist = b.call(lambda pkg, funk: pkg.stakes.read_stake_history(
        funk, "blk"))
    assert set(hist) == {3, 4}
    assert b.account(TORCH.sysvars.STAKE_HISTORY_ID) is not None
