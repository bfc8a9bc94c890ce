"""The port's pack (pack/cost.py, pack/scheduler.py) against the JAX
package's: compute_cost and meta_from_payload on the payloads of
tests/test_pack_cost.py, and PackScheduler on the non-bundle cases of
tests/test_pack.py and tests/test_pack_cost.py, both schedulers driven in
lockstep over the same transactions: the same microblocks, in the same
order, with the same metrics. Exact."""
import dataclasses
import random

import pytest

from firedancer_tpu.pack import cost as jcost
from firedancer_tpu.pack import scheduler as jsched
from firedancer_tpu.protocol.txn import build_message, build_txn
from firedancer_tpu.protocol.txn import parse_txn as jparse
from firedancer_tpu.tiles.synth import make_signed_txns
from firedancer_tpu_torch.pack import cost as tcost
from firedancer_tpu_torch.pack import scheduler as tsched
from firedancer_tpu_torch.protocol.txn import parse_txn as tparse

CB = jcost.COMPUTE_BUDGET_PROGRAM_ID
UNK = b"\x66" * 32


def _payload(instrs, extra_accounts, n_signers=1, n_ro_unsigned=0,
             version=-1):
    signers = [bytes([0x40 + i]) * 32 for i in range(n_signers)]
    msg = build_message(signers, extra_accounts, b"\xbb" * 32, instrs,
                        n_ro_unsigned=n_ro_unsigned, version=version)
    return build_txn([b"\x01" * 64] * n_signers, msg)


def _cb_ix(kind, value, width=4):
    return bytes([kind]) + value.to_bytes(width, "little")


def _vote(i):
    msg = build_message([bytes([i + 1]) * 32],
                        [bytes([0x80 + i]) * 32, jcost.VOTE_PROGRAM_ID],
                        b"\xbb" * 32, [(2, bytes([1]), b"\x00" * 8)],
                        n_ro_unsigned=1)
    return build_txn([b"\x01" * 64], msg)


COST_PAYLOADS = {
    "default": _payload([(2, bytes([1]), b"abc")],
                        [b"\x55" * 32, b"\x77" * 32], n_ro_unsigned=1),
    "builtin_and_not": _payload([(1, b"", b""), (2, b"", b"")],
                                [jcost.SYSTEM_PROGRAM_ID, UNK]),
    "cu_limit_and_price": _payload(
        [(1, b"", _cb_ix(2, 500_000)), (1, b"", _cb_ix(3, 2_000_000, 8)),
         (2, b"", b"\x00" * 8)], [CB, UNK]),
    "cu_limit_clamped": _payload(
        [(1, b"", _cb_ix(2, 100_000_000)),
         (1, b"", _cb_ix(3, 2_000_000, 8)), (2, b"", b"\x00" * 8)],
        [CB, UNK]),
    "loaded_data": _payload([(1, b"", _cb_ix(4, 33 * 1024))], [CB]),
    "loaded_data_zero": _payload([(1, b"", _cb_ix(4, 0))], [CB]),
    "duplicate_cu": _payload([(1, b"", _cb_ix(2, 1000)),
                              (1, b"", _cb_ix(2, 1000))], [CB]),
    "short_cb": _payload([(1, b"", b"\x02\x01")], [CB]),
    "deprecated_kind": _payload([(1, b"", _cb_ix(0, 5))], [CB]),
    "heap_unaligned": _payload([(1, b"", _cb_ix(1, 1025))], [CB]),
    "heap_aligned": _payload([(1, b"", _cb_ix(1, 4096))], [CB]),
    "precompiles": _payload(
        [(1, b"", b"\x03" + b"\x00" * 10), (2, b"", b"\x02" + b"\x00" * 10)],
        [jcost.ED25519_SV_PROGRAM_ID, jcost.KECCAK_SECP_PROGRAM_ID],
        n_ro_unsigned=2),
    "simple_vote": _payload([(2, bytes([1]), b"\x00" * 20)],
                            [b"\x11" * 32, jcost.VOTE_PROGRAM_ID]),
    "v0_vote": _payload([(2, bytes([1]), b"\x00" * 20)],
                        [b"\x11" * 32, jcost.VOTE_PROGRAM_ID], version=0),
    "reward_priority": _payload(
        [(1, b"", _cb_ix(2, 1_000_000)), (1, b"", _cb_ix(3, 5_000_000, 8)),
         (2, b"", b"")], [CB, UNK]),
    "max_cost": _payload([(1, b"", _cb_ix(2, jcost.MAX_CU_LIMIT)),
                          (2, b"", b"")], [CB, UNK], n_signers=9),
    "synth_transfer": make_signed_txns(1, seed=3)[0],
}


def _outcome(fn):
    try:
        r = fn()
    except Exception as e:
        return ("raises", type(e).__name__)
    if dataclasses.is_dataclass(r):
        d = dataclasses.asdict(r)
        d.pop("txn", None)
        return d
    return r


@pytest.mark.parametrize("case", sorted(COST_PAYLOADS))
def test_compute_cost_matches_reference(case):
    p = COST_PAYLOADS[case]
    assert _outcome(lambda: tcost.compute_cost(tparse(p), p)) \
        == _outcome(lambda: jcost.compute_cost(jparse(p), p))
    assert _outcome(lambda: tsched.meta_from_payload(p)) \
        == _outcome(lambda: jsched.meta_from_payload(p))
    assert _outcome(lambda: tsched.txn_cost_and_reward(tparse(p), p)) \
        == _outcome(lambda: jsched.txn_cost_and_reward(jparse(p), p))


# -- the scheduler ---------------------------------------------------------

def _raw(tag, writes, reads=(), reward=5000, cost=10_000, vote=False):
    """(tag, writes, reads, reward, cost, vote) of one txn, payload = its
    tag (tests/test_pack.py::mk_meta)."""
    return (tag.to_bytes(4, "little"),
            tuple(bytes([w]) * 32 for w in writes),
            tuple(bytes([r]) * 32 for r in reads), reward, cost, vote)


class Pair:
    """Both packages' schedulers, one call at a time, results compared
    as they come."""

    def __init__(self, banks=1, **limits):
        self.s = [m.PackScheduler(bank_cnt=banks,
                                  limits=m.PackLimits(**limits))
                  for m in (jsched, tsched)]

    def insert_raw(self, raw):
        payload, w, r, reward, cost, vote = raw
        tids = [s.insert(m.TxnMeta(payload=payload, txn=None, reward=reward,
                                   cost=cost, writes=w, reads=r,
                                   is_vote=vote))
                for s, m in zip(self.s, (jsched, tsched))]
        assert tids[0] == tids[1]

    def insert_payload(self, p):
        tids = [s.insert(m.meta_from_payload(p))
                for s, m in zip(self.s, (jsched, tsched))]
        assert tids[0] == tids[1]

    def schedule(self, bank):
        mbs = [[mt.payload for mt in s.schedule_microblock(bank)]
               for s in self.s]
        assert mbs[0] == mbs[1]
        return mbs[1]

    def call(self, name, *a):
        out = [getattr(s, name)(*a) for s in self.s]
        assert out[0] == out[1]
        return out[1]

    def state(self):
        st = [(s.pending_cnt, dict(s.metrics),
               [[mt.payload for mt in s.outstanding(b)]
                for b in range(s.bank_cnt)]) for s in self.s]
        assert st[0] == st[1]
        return st[1]


def _case_non_conflicting():
    p = Pair(banks=2)
    for raw in (_raw(0, [1], reward=9000), _raw(1, [2], reward=8000),
                _raw(2, [1], reward=7000)):
        p.insert_raw(raw)
    assert len(p.schedule(0)) == 2 and p.schedule(1) == []
    p.call("microblock_done", 0)
    assert len(p.schedule(1)) == 1
    return p


def _case_read_write():
    p = Pair(banks=2)
    for raw in (_raw(0, [1], [], 9000), _raw(1, [], [1], 8000),
                _raw(2, [], [2], 7000), _raw(3, [2], [], 6000)):
        p.insert_raw(raw)
    p.schedule(0)
    p.schedule(1)
    return p


def _case_priority():
    p = Pair(max_txn_per_microblock=100)
    for i, r in enumerate([3000, 9000, 1000, 7000, 5000]):
        p.insert_raw(_raw(i, [i + 1], reward=r))
    assert len(p.schedule(0)) == 5
    return p


def _case_block_cost():
    p = Pair(max_cost_per_block=25_000, max_txn_per_microblock=10)
    for i in range(5):
        p.insert_raw(_raw(i, [i + 1]))
    assert len(p.schedule(0)) == 2
    p.call("microblock_done", 0)
    assert p.schedule(0) == []
    p.call("end_block")
    assert len(p.schedule(0)) == 2
    return p


def _case_write_cost():
    p = Pair(max_write_cost_per_acct=15_000, max_txn_per_microblock=10)
    for i in range(4):
        p.insert_raw(_raw(i, [7]))
    for _ in range(4):
        p.schedule(0)
        p.call("microblock_done", 0)
    p.call("end_block")
    assert len(p.schedule(0)) == 1
    return p


def _case_vote_cost():
    p = Pair(max_vote_cost_per_block=10_000, max_txn_per_microblock=10)
    for i in range(3):
        p.insert_raw(_raw(i, [i + 1], cost=6_000, vote=True))
    assert len(p.schedule(0)) == 1
    return p


def _case_bitset_reuse():
    p = Pair()
    p.insert_raw(_raw(0, [1]))
    p.schedule(0)
    p.call("microblock_done", 0)
    p.insert_raw(_raw(1, [2]))
    p.insert_raw(_raw(2, [2]))
    assert len(p.schedule(0)) == 1
    return p


def _case_vote_limit_payloads():
    p = Pair(max_vote_cost_per_block=2 * jcost.SIMPLE_VOTE_COST + 1,
             max_txn_per_microblock=10)
    for i in range(4):
        p.insert_payload(_vote(i))
    assert len(p.schedule(0)) == 2
    return p


def _case_synth_transfers():
    """The leader topology's traffic: synth transfers from 16 signers,
    31 txns a microblock, four outstanding."""
    p = Pair(max_txn_per_microblock=31)
    for t in make_signed_txns(48, seed=17):
        p.insert_payload(t)
    for _ in range(12):
        p.schedule(0)
        if p.call("outstanding_cnt", 0) >= 4:
            p.call("microblock_done", 0)
    p.call("end_block")
    return p


def _case_randomized():
    """tests/test_pack.py::test_randomized_invariants, in lockstep."""
    rng = random.Random(42)
    p = Pair(banks=4, max_cost_per_block=500_000,
             max_write_cost_per_acct=120_000, max_txn_per_microblock=4,
             probe_depth=32)
    for i in range(200):
        nw, nr = rng.randint(1, 3), rng.randint(0, 2)
        univ = list(range(1, 12))
        rng.shuffle(univ)
        p.insert_raw(_raw(i, univ[:nw], univ[nw:nw + nr],
                          reward=rng.randint(1000, 50_000),
                          cost=rng.randint(5_000, 30_000)))
    busy, blocks, scheduled = [False] * 4, 0, 0
    for _ in range(5000):
        bank = rng.randrange(4)
        if busy[bank] and rng.random() < 0.6:
            p.call("microblock_done", bank)
            busy[bank] = False
            continue
        if busy[bank]:
            continue
        mb = p.schedule(bank)
        if not mb:
            if not any(busy):
                p.call("end_block")
                blocks += 1
                if blocks > 300:
                    break
            continue
        busy[bank] = True
        scheduled += len(mb)
        if p.state()[0] == 0 and not any(busy):
            break
    assert scheduled == 200
    return p


SCHED_CASES = {name[6:]: fn for name, fn in globals().items()
               if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_matches_reference(case):
    SCHED_CASES[case]().state()
