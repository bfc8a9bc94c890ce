"""The port's transaction status cache (firedancer_tpu_torch/svm/txncache.py,
exported by svm/__init__.py with MAX_CACHE_AGE_SLOTS) against the JAX
package's: the scenarios of tests/test_accdb_txncache.py (fork-aware
queries, rooted history, pruning by age, the abandoned fork's purge at a
root, no replay within the window) and seeded random streams of inserts,
queries and root registrations. Every query's answer and the cache's
size equal (exact)."""
import random

import pytest

from firedancer_tpu import svm as jsvm
from firedancer_tpu.svm import txncache as jtc
from firedancer_tpu_torch import svm as tsvm
from firedancer_tpu_torch.svm import txncache as ttc

MODS = (jtc, ttc)
BH, SIG = b"h" * 32, b"s" * 64


def test_exports_match_reference():
    assert tsvm.MAX_CACHE_AGE_SLOTS == jsvm.MAX_CACHE_AGE_SLOTS == 150
    assert tsvm.TxnCache is ttc.TxnCache


def both(steps, **kw):
    """steps: [(op, args)] on a fresh cache of each package. -> the
    port's answers once both agree."""
    got = []
    for mod in MODS:
        tc = mod.TxnCache(**kw)
        out = []
        for op, args in steps:
            r = getattr(tc, op)(*args)
            if op != "insert" and op != "register_root":
                out.append(r)
        out.append(len(tc))
        got.append(out)
    assert got[1] == got[0]
    return got[1]


SCENARIOS = {
    "fork_aware": ([
        ("insert", (10, BH, SIG, 0)),
        ("query", (BH, SIG, {8, 9, 10})), ("query", (BH, SIG, {8, 9, 11})),
        ("query", (BH, b"z" * 64, {10})), ("query", (b"x" * 32, SIG, {10})),
        ("insert", (11, BH, SIG, 1)),
        ("query", (BH, SIG, {11})), ("query", (BH, SIG, {10}))],
        {}, [0, None, None, None, 1, 0, 1]),
    "rooted_history": ([
        ("insert", (10, BH, SIG)), ("register_root", (12,)),
        ("query", (BH, SIG, set()))], {}, [0, 1]),
    "prunes_aged": ([
        ("insert", (5, b"o" * 32, b"a" * 64)),
        ("insert", (100, b"n" * 32, b"b" * 64)),
        ("register_root", (50,)),
        ("query", (b"o" * 32, b"a" * 64, {5})),
        ("query", (b"n" * 32, b"b" * 64, {100}))],
        {"max_age_slots": 20}, [None, 0, 1]),
    "abandoned_fork_purged": ([
        ("insert", (5, BH, SIG)), ("insert", (6, BH, b"t" * 64)),
        ("register_root", (10, {6, 7, 8, 9, 10})),
        ("query", (BH, SIG, {6, 7, 8, 9, 10})),
        ("query", (BH, b"t" * 64, set()))], {}, [None, 0, 1]),
    "callable_ancestors": ([
        ("insert", (7, BH, SIG, 3)),
        ("query", (BH, SIG, lambda s: s % 7 == 0)),
        ("query", (BH, SIG, lambda s: False)),
        ("register_root", (20, lambda s: s != 7)),
        ("query", (BH, SIG, lambda s: True))], {}, [3, None, None, 0]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    steps, kw, want = SCENARIOS[name]
    assert both(steps, **kw) == want


@pytest.mark.parametrize("seed", [3, 5, 7, 11])
def test_random_streams_match_reference(seed):
    """Inserts on two forks of a slot chain, queries against either
    fork's ancestors, and roots that advance along one fork, with
    signatures drawn from a small alphabet (collisions) and a short age
    window so pruning runs."""
    rng = random.Random(seed)
    steps, root = [], 0
    forks = [set(), set()]
    for slot in range(1, 120):
        f = rng.randrange(2)
        forks[f].add(slot)
        for _ in range(rng.randrange(4)):
            bh = bytes([rng.randrange(4)]) * 32
            sig = bytes([rng.randrange(6)]) * 64
            if rng.random() < 0.5:
                steps.append(("insert", (slot, bh, sig, rng.randrange(3))))
            else:
                steps.append(("query", (bh, sig, set(forks[rng.randrange(
                    2)]))))
        if slot % 9 == 0:
            root = slot - rng.randrange(4)
            steps.append(("register_root", (root, set(forks[0]))))
    both(steps, max_age_slots=30)


def test_no_replay_within_window():
    """The consensus property on both: a signature executes at most once
    on one fork while its blockhash is live."""
    rng = random.Random(5)
    caches = [m.TxnCache() for m in MODS]
    ancestors, executed = set(), set()
    for slot in range(1, 30):
        ancestors.add(slot)
        sig = bytes(rng.randrange(4) for _ in range(64))
        hits = [tc.query(b"r" * 32, sig, ancestors) for tc in caches]
        assert hits[1] == hits[0]
        if hits[1] is None:
            for tc in caches:
                tc.insert(slot, b"r" * 32, sig)
            assert sig not in executed
            executed.add(sig)
