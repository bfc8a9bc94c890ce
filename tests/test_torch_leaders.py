"""The port's epoch leader schedule (flamenco/leaders.py, a copy of the
JAX package's, on the port's utils/chacha.py) against the reference's:
the leader cases of tests/test_leaders_repair.py in lockstep
(tests/torch_lockstep.py), and the stake-weighted sampling of
tests/test_leaders_agave.py on a seeded mainnet-shaped stake table
(3,373 node identities, heavy-tailed stakes, duplicate stakes for the
pubkey tie-break): the same sorted table, the same draws with Agave's
epoch key, the same schedule, rotations and excluded-stake tail."""
import numpy as np
import pytest

import test_leaders_repair
from torch_lockstep import lockstep

from firedancer_tpu.flamenco import leaders as jl
from firedancer_tpu.utils.chacha import ChaChaRng as JRng
from firedancer_tpu_torch.flamenco import leaders as tl
from firedancer_tpu_torch.utils.chacha import ChaChaRng as TRng


@pytest.mark.parametrize("case", sorted(
    n for n in vars(test_leaders_repair) if n.startswith("test_leaders")))
def test_leader_cases_match_reference(case):
    rec = lockstep(getattr(test_leaders_repair, case),
                   {"EpochLeaders": "flamenco.leaders.EpochLeaders"})
    assert rec


def _stakes(n=3373, seed=454):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (n, 32), np.uint8)
    stake = (rng.pareto(1.2, n) * 1e9).astype(np.int64) + 1
    stake[::97] = stake[0]                 # equal stakes: pubkey tie-break
    stake[5] = 0                           # zero stake never leads
    return {bytes(k): int(s) for k, s in zip(keys, stake)}


STAKES = _stakes()


def test_sorted_table_and_sampler_draws_match():
    weighted = tl.sort_stakes(STAKES)
    assert weighted == jl.sort_stakes(STAKES)
    assert len(weighted) == len(STAKES) - 1
    ts, js = tl.WeightedSampler(weighted), jl.WeightedSampler(weighted)
    tr, jr = TRng(tl.epoch_seed(454)), JRng(jl.epoch_seed(454))
    got = [ts.sample_idx(tr) for _ in range(4096)]
    assert got == [js.sample_idx(jr) for _ in range(4096)]
    assert len(set(got)) > 100


@pytest.mark.parametrize("epoch,seed,spe", [
    (454, None, 8192), (0, None, 4000), (7, b"\x05" * 32, 4099)])
def test_epoch_schedule_matches(epoch, seed, spe):
    t = tl.EpochLeaders(epoch, seed, STAKES, spe)
    j = jl.EpochLeaders(epoch, seed, STAKES, spe)
    assert (t.pub, t.sched) == (j.pub, j.sched)
    slot0 = epoch * spe
    slots = range(slot0, slot0 + spe, 13)
    assert [t.leader_for(s) for s in slots] == \
        [j.leader_for(s) for s in slots]
    for key in t.pub[:8]:
        assert t.leader_slots(key) == j.leader_slots(key)
    with pytest.raises(ValueError):
        t.leader_for(slot0 + spe)


def test_excluded_stake_tail_matches():
    weighted = tl.sort_stakes(STAKES)
    short = len(weighted) // 2
    excluded = sum(s for _, s in weighted[short:])
    ts = tl.WeightedSampler(weighted[:short], excluded=excluded)
    js = jl.WeightedSampler(weighted[:short], excluded=excluded)
    tr, jr = TRng(tl.epoch_seed(454)), JRng(jl.epoch_seed(454))
    got = [ts.sample(tr) for _ in range(2048)]
    assert got == [js.sample(jr) for _ in range(2048)]
    assert tl.INDETERMINATE_LEADER in got
    assert tl.INDETERMINATE_LEADER == jl.INDETERMINATE_LEADER
