"""Inputs of the wave scan's tests, made with numpy and the port's
SystemTxn and nothing of JAX, so the card's tests can use them too:
named blocks of system transfers with their genesis balances."""
import hashlib

import numpy as np

from firedancer_tpu_torch.svm import executor as texec

U64 = (1 << 64) - 1


def keys_of(n, tag=b"k"):
    return [hashlib.sha256(tag + b"%d" % i).digest() for i in range(n)]


def rand_block(rng, n_txn, n_acct, hot_frac=0.5, amt_max=2_000,
                fee_max=10):
    """Conflict-heavy random block (tests/test_replay.py::rand_block):
    a few hot accounts in half the txns, so the DAG has long chains and
    wide waves."""
    keys = keys_of(n_acct)
    hot = keys[:max(1, n_acct // 8)]
    txns = []
    for _ in range(n_txn):
        pool = hot if rng.random() < hot_frac else keys
        txns.append(texec.SystemTxn(
            pool[rng.integers(len(pool))], keys[rng.integers(len(keys))],
            int(rng.integers(0, amt_max)), int(rng.integers(0, fee_max))))
    return keys, txns


def u64_edges(rng):
    """Balances >= 2^63, amount + fee wrapping past 2^64 (which the
    reference's carry chain wraps, so a huge transfer may pass), exact
    hi-word borrows (lo < sub_lo) and fees at the balance's edge."""
    keys = keys_of(10, b"e")
    big = [(1 << 63) + int(rng.integers(0, 1 << 62)), U64, 1 << 63,
           (1 << 32) + 5, (5 << 32), (1 << 32) - 1, 7, 0, 1 << 40,
           (3 << 32) + 1]
    t = texec.SystemTxn
    txns = [
        t(keys[0], keys[1], 1 << 63, 1 << 63),        # need wraps to 0
        t(keys[1], keys[2], U64, 2),                  # need wraps to 1
        t(keys[2], keys[3], (1 << 63) + 1, U64),      # wraps, fee fails?
        t(keys[3], keys[4], 6, 0),                    # borrow from hi
        t(keys[4], keys[5], 1, (5 << 32)),            # fee == balance
        t(keys[5], keys[6], (1 << 32), 0),            # insufficient
        t(keys[6], keys[7], 1, 7),                    # fee only
        t(keys[7], keys[7], 0, 0),                    # zero self
        t(keys[8], keys[0], 1 << 39, 1 << 39),        # exactly funded
        t(keys[9], keys[9], 1 << 32, 1),              # self, hi words
        t(keys[0], keys[9], U64 - 3, 3),              # need == 2^64 - 1
    ]
    txns += [t(keys[int(rng.integers(10))], keys[int(rng.integers(10))],
               int(rng.integers(0, 1 << 63)) * int(rng.integers(1, 3)),
               int(rng.integers(0, 1 << 33))) for _ in range(40)]
    return dict(zip(keys, big)), txns


def wave_cases():
    """(balances {key: u64}, txns) for every named case."""
    out = {}
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        keys, txns = rand_block(rng, 120, 20)
        out[f"random{seed}"] = (
            {k: int(rng.integers(0, 50_000)) for k in keys[::2]}, txns)
    out["u64_edges"] = u64_edges(np.random.default_rng(4))
    a, b, c = keys_of(3, b"s")
    t = texec.SystemTxn
    out["self_transfer"] = ({a: 100}, [t(a, a, 30, 5), t(a, a, 200, 1),
                                       t(a, b, 10, 1)])
    out["fee_only_failure"] = ({a: 10, b: 3}, [t(a, c, 100, 4),
                                               t(b, c, 1, 4),
                                               t(a, b, 6, 0)])
    out["empty"] = ({a: 1}, [])
    for n in (1, 5, 17):      # across the reference's pow2 bucket edges
        out[f"block{n}"] = ({a: 1_000_000},
                            [t(a, b, 10, 1) for _ in range(n)])
    return out
