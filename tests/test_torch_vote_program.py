"""The port's vote program (firedancer_tpu_torch/svm/vote.py on
choreo/tower.py) against the JAX package's: the cases of
tests/test_vote_program.py, each run through both packages' executors on
the same accounts with equal statuses, fees, logs and byte-equal
accounts (tests/torch_svm_parity.Both), and the vote state's wire and
epoch-credit history on both."""
import struct

import pytest

from torch_svm_parity import JAX, PKGS, TORCH, Both, k, txn

PAYER, VOTER, NODE, VOTE_ACCT, DEST = k(1), k(2), k(3), k(4), k(5)
VOTE = TORCH.vote.VOTE_PROGRAM_ID


@pytest.fixture
def b():
    return Both({PAYER: 10_000_000,
                 VOTE_ACCT: dict(lamports=5_000, owner=VOTE)},
                enforce_rent=False)


def _init(b):
    return b.run(txn([PAYER, NODE], [VOTE_ACCT, VOTE],
                     [(3, [2], TORCH.vote.ix_initialize(NODE, VOTER,
                                                        VOTER))]))


def _state(b):
    return TORCH.vote.VoteState.from_bytes(b.account(VOTE_ACCT).data)


def test_ids_and_instruction_data_match_reference():
    assert TORCH.vote.VOTE_PROGRAM_ID == JAX.vote.VOTE_PROGRAM_ID
    for name, args in (("ix_initialize", (NODE, VOTER, DEST, 7)),
                       ("ix_vote", ([1, 2, 9], k(9), 123)),
                       ("ix_vote", ([4], k(8), None)),
                       ("ix_tower_sync", ([(5, 2), (6, 1)], 3, k(1), k(2),
                                          77)),
                       ("ix_tower_sync", ([(5, 1)], None, k(1), k(2),
                                          None)),
                       ("ix_withdraw", (99,))):
        assert getattr(TORCH.vote, name)(*args) == \
            getattr(JAX.vote, name)(*args)


def test_initialize_and_vote(b):
    assert _init(b) == "ok"
    st = _state(b)
    assert st.node_pubkey == NODE and st.authorized_voter == VOTER
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], TORCH.vote.ix_vote([1, 2, 3]))])) == "ok"
    st = _state(b)
    assert [(v.slot, v.conf) for v in st.tower.votes] == \
        [(1, 3), (2, 2), (3, 1)]
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], TORCH.vote.ix_vote([2, 50]))])) == "ok"
    assert [v.slot for v in _state(b).tower.votes] == [50]


def test_tower_sync_and_timestamps(b):
    assert _init(b) == "ok"
    b.set(epoch=3)
    sync = TORCH.vote.ix_tower_sync([(s, 1) for s in range(1, 36)], None,
                                    k(7), k(8), timestamp=1_700_000_000)
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], sync)])) == "ok"
    st = _state(b)
    assert st.last_ts == 1_700_000_000 and st.root_slot == 4
    assert st.epoch_credits == [(3, 4, 0)]
    # a truncated TowerSync is bad instruction data on both
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], sync[:-40])])) == "bad_instruction_data"


def test_vote_requires_authorized_voter(b):
    assert _init(b) == "ok"
    assert b.run(txn([PAYER], [VOTE_ACCT, VOTE],
                     [(2, [1], TORCH.vote.ix_vote([1]))])) == \
        "missing_required_signature"


def test_initialize_requires_node_signature(b):
    assert b.run(txn([PAYER], [VOTE_ACCT, VOTE],
                     [(2, [1], TORCH.vote.ix_initialize(NODE, VOTER,
                                                        VOTER))])) == \
        "missing_required_signature"


def test_vote_rooting_accrues_credits(b):
    assert _init(b) == "ok"
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], TORCH.vote.ix_vote(list(range(1, 40))))])) \
        == "ok"
    st = _state(b)
    assert st.root_slot == 8 and st.credits == 8
    assert len(st.tower.votes) == 31


def test_withdraw_authority_and_funds(b):
    assert _init(b) == "ok"
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, DEST, VOTE],
                     [(4, [2, 3], TORCH.vote.ix_withdraw(3_000))])) == "ok"
    assert b.account(VOTE_ACCT).lamports == 2_000
    assert b.account(DEST).lamports == 3_000
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, DEST, VOTE],
                     [(4, [2, 3], TORCH.vote.ix_withdraw(10_000))])) == \
        "insufficient_funds"
    assert b.run(txn([PAYER], [VOTE_ACCT, DEST, VOTE],
                     [(3, [1, 2], TORCH.vote.ix_withdraw(1))])) == \
        "missing_required_signature"


def test_vote_on_non_vote_account_refused(b):
    assert b.run(txn([PAYER, VOTER], [PAYER, VOTE],
                     [(3, [0], TORCH.vote.ix_vote([1]))])) == \
        "invalid_account_owner"


def test_authorize_and_update_commission(b):
    v = TORCH.vote
    assert _init(b) == "ok"
    new_voter, evil = k(0x51), k(0x66)
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], struct.pack("<I", v.VOTE_IX_AUTHORIZE)
                       + new_voter
                       + struct.pack("<I", v.AUTH_KIND_VOTER))])) == "ok"
    assert _state(b).authorized_voter == new_voter
    b.write(evil, lamports=1 << 30)
    assert b.run(txn([evil], [VOTE_ACCT, VOTE],
                     [(2, [1], struct.pack("<I", v.VOTE_IX_AUTHORIZE)
                       + evil
                       + struct.pack("<I", v.AUTH_KIND_WITHDRAWER))])) == \
        "missing_required_signature"
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], struct.pack("<I", v.VOTE_IX_UPDATE_COMMISSION)
                       + bytes([42]))])) == "ok"
    assert _state(b).commission == 42
    # an unknown authorize kind and an unknown instruction
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], struct.pack("<I", v.VOTE_IX_AUTHORIZE)
                       + evil + struct.pack("<I", 9))])) == \
        "bad_instruction_data"
    assert b.run(txn([PAYER, VOTER], [VOTE_ACCT, VOTE],
                     [(3, [2], struct.pack("<I", 11))])) == \
        "bad_instruction_data"


def _roundtrip(pkg):
    st = pkg.vote.VoteState(NODE, VOTER, VOTER, commission=5)
    st.apply_vote([1, 2, 3, 9], timestamp=4, epoch=2)
    st.credits = 7
    st.root_slot = 1
    b = st.to_bytes()
    assert pkg.vote.VoteState.from_bytes(b).to_bytes() == b
    return b


def test_state_roundtrip():
    assert _roundtrip(TORCH) == _roundtrip(JAX)


def _credits(pkg, history, credits, epochs):
    st = pkg.vote.VoteState(k(1), k(2), k(2))
    st.epoch_credits = list(history)
    st.credits = credits
    out = []
    for e in epochs:
        st._increment_credits(epoch=e)
        out.append((list(st.epoch_credits), st.credits))
    return out


@pytest.mark.parametrize("history,credits,epochs", [
    ((), 1000, (7, 7, 8)),
    (((3, 10, 4), (5, 10, 10)), 10, (9, 10)),
    (tuple((e, e + 1, e) for e in range(64)), 64, (99, 99, 100))])
def test_epoch_credits_match_reference(history, credits, epochs):
    got = [_credits(p, history, credits, epochs) for p in PKGS]
    assert got[1] == got[0]
