"""The port's epoch boundary (firedancer_tpu_torch/flamenco/stakes.py,
flamenco/rewards.py) against the JAX package's: the inflation schedule,
the points and commission split, `update_stake_history`,
`distribute_epoch_rewards` (partitioned by the parent blockhash) and the
paid-through marker, on the same funk with equal stores (exact)."""
import hashlib

import pytest

from torch_svm_parity import JAX, PKGS, TORCH, Both, k

SPE = 432_000


def _mk(voters, stakes, rewarded_epoch=1):
    """voters: vote_key -> (commission, credits_in_epoch); stakes:
    stake_key -> (vote_key, amount). -> Both over those accounts (the
    port's state built by the port's modules, the reference's by its)."""
    b = Both({})

    def build(pkg, funk):
        for vk, (comm, credits) in voters.items():
            vs = pkg.vote.VoteState(vk, vk, vk, commission=comm)
            for _ in range(credits):
                vs._increment_credits(rewarded_epoch)
            funk.rec_write("blk", vk, pkg.accdb.Account(
                1_000_000, bytearray(vs.to_bytes()),
                pkg.vote.VOTE_PROGRAM_ID))
        for sk, (vk, amt) in stakes.items():
            st = pkg.stake.StakeState(
                state=pkg.stake.ST_DELEGATED, staker=sk, withdrawer=sk,
                voter=vk, amount=amt, activation_epoch=rewarded_epoch - 1)
            funk.rec_write("blk", sk, pkg.accdb.Account(
                amt, bytearray(st.to_bytes()), pkg.stake.STAKE_PROGRAM_ID))
    b.call(build)
    return b


@pytest.mark.parametrize("epoch,spe", [(0, SPE), (183, SPE), (7320, SPE),
                                       (183 * 40, SPE), (1, 8), (9, 32)])
def test_inflation_schedule_matches_reference(epoch, spe):
    got = [(p.rewards.inflation_rate_bps(epoch, spe),
            p.rewards.epoch_validator_issuance(10**15, epoch, spe))
           for p in PKGS]
    assert got[1] == got[0]


def test_points_and_commission_split_match_reference():
    v1, v2 = k(1), k(2)
    b = _mk({v1: (0, 10), v2: (50, 10), k(3): (10, 0)},
            {k(0x0a): (v1, 3_000_000), k(0x0b): (v1, 1_000_000),
             k(0x0c): (v2, 4_000_000), k(0x0d): (k(3), 5_000)})
    rewards, points = b.call(lambda pkg, funk: pkg.rewards
                             .calculate_stake_rewards(funk, "blk", 1,
                                                      1_000_000))
    assert points == 80_000_000 and len(rewards) == 3


def test_update_stake_history_matches_reference():
    b = _mk({k(1): (0, 3)}, {k(0x0a): (k(1), 1_000_000),
                             k(0x0b): (k(1), 2_000_000)})
    for e in (0, 1, 2, 5):
        b.call(lambda pkg, funk, e=e: pkg.stakes.update_stake_history(
            funk, "blk", e))
    hist = b.call(lambda pkg, funk: pkg.stakes.read_stake_history(
        funk, "blk"))
    assert set(hist) == {0, 1, 2, 5}


@pytest.mark.parametrize("n_stakes,spe", [(40, SPE), (4100, 32)])
def test_distribute_epoch_rewards_matches_reference(n_stakes, spe):
    """The bank's boundary duty as disco/tiles.py runs it: stake history,
    then the rewards of each crossed epoch under the parent blockhash
    sha256(b"epoch-%d" % (e + 1)), then the marker. 4100 stake
    accounts make two partitions."""
    voters = {k(i + 1): (i * 7 % 100, 3 + i) for i in range(8)}
    stakes = {hashlib.sha256(b"s%d" % i).digest():
              (k(i % 8 + 1), 10**9 * (1000 + i)) for i in range(n_stakes)}
    b = _mk(voters, stakes)

    def boundary(pkg, funk):
        out = []
        start = pkg.rewards.paid_through(funk, "blk")
        for e in range(start, 3):
            pkg.stakes.update_stake_history(funk, "blk", e)
            out.append(pkg.rewards.distribute_epoch_rewards(
                funk, "blk", e, None, spe,
                hashlib.sha256(b"epoch-%d" % (e + 1)).digest()))
        pkg.rewards.mark_paid_through(funk, "blk", 3)
        return out, pkg.rewards.paid_through(funk, "blk")

    summaries, marker = b.call(boundary)
    assert marker == 3 and summaries[1]["paid"] > 0
    assert summaries[1]["partitions"] == (2 if n_stakes > 4096 else 1)
    # a restarted bank reads the marker and pays nothing again
    assert b.call(boundary) == ([], 3)


def test_partitions_match_reference():
    bh = b"\x33" * 32
    keys = [bytes([i]) * 32 for i in range(200)]
    for parts in (1, 3, 4):
        assert [TORCH.rewards.partition_of(s, bh, parts) for s in keys] == \
            [JAX.rewards.partition_of(s, bh, parts) for s in keys]
    assert TORCH.rewards.REWARDS_MARKER_KEY == JAX.rewards.REWARDS_MARKER_KEY
