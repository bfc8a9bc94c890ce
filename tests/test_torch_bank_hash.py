"""The port's bank hash (firedancer_tpu_torch/flamenco/bank_hash.py, its
lthash lanes from ops/blake3.lthash_batch: the plain version on the CPU)
against the JAX package's (its host oracle on the CPU backend), on the
same accounts made from a seed: serialize_account, accounts_lthash,
BankHasher.apply_delta / apply_txn_delta / bank_hash, and
lthash_of_root. Exact: lattice lanes and hashes are bytes."""
import numpy as np
import pytest

from firedancer_tpu.flamenco import bank_hash as jbh
from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu.svm import accdb as jaccdb
from firedancer_tpu_torch.flamenco import bank_hash as tbh
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.svm import accdb as taccdb


def k(n):
    return bytes([n]) * 32


def _accounts(rng, n, zero_every=0):
    """[(pubkey, fields)] of random accounts: data of 0-300 bytes, now and
    then over 2,048 bytes, executable or not, random owners."""
    out = []
    for i in range(n):
        size = int(rng.integers(0, 300)) if i % 7 else int(
            rng.integers(2000, 5000))
        lam = 0 if zero_every and i % zero_every == 0 else int(
            rng.integers(1, 1 << 62))
        out.append((rng.bytes(32), dict(
            lamports=lam, data=rng.bytes(size), owner=rng.bytes(32),
            executable=bool(i % 3 == 1),
            rent_epoch=int(rng.integers(0, 1 << 63)))))
    return out


@pytest.mark.parametrize("data_len", [0, 1, 1966, 1967, 1968, 2048, 6000])
@pytest.mark.parametrize("executable", [False, True])
def test_serialize_account_matches_reference(data_len, executable):
    """The field order and the sha256 fold of data that would pass the
    2,048-byte lane (16 head + data + 65 tail: 1967 is the last that
    fits)."""
    rng = np.random.default_rng(data_len + executable)
    f = dict(lamports=int(rng.integers(1, 1 << 63)),
             data=rng.bytes(data_len), owner=rng.bytes(32),
             executable=executable, rent_epoch=7)
    got = tbh.serialize_account(k(3), taccdb.Account(**f))
    assert got == jbh.serialize_account(k(3), jaccdb.Account(**f))
    assert len(got) <= tbh.LT_MSG_MAX
    assert (len(got) == 16 + data_len + 65) == (data_len <= 1967)


@pytest.mark.parametrize("n,zero_every", [(1, 0), (5, 2), (40, 0),
                                          (33, 4)])
def test_accounts_lthash_matches_reference(n, zero_every):
    rng = np.random.default_rng(n)
    items = _accounts(rng, n, zero_every)
    got = tbh.accounts_lthash(
        [(pk, taccdb.Account(**f)) for pk, f in items] + [(k(1), None)],
        device="cpu")
    want = jbh.accounts_lthash(
        [(pk, jaccdb.Account(**f)) for pk, f in items] + [(k(1), None)])
    assert got.dtype == np.uint16 and np.array_equal(got, want)


def test_empty_delta_is_zeros_and_launches_nothing(monkeypatch):
    from firedancer_tpu_torch.ops import cuda_blake3

    def boom(*a):
        raise AssertionError("lthash launched for an empty delta")
    monkeypatch.setattr(cuda_blake3, "lthash", boom)
    got = tbh.accounts_lthash([(k(1), taccdb.Account()), (k(2), None)],
                              device="cuda")
    assert got.dtype == np.uint16 and not got.any()


def _funks(items):
    out = []
    for fk, ad in ((jfunk, jaccdb), (tfunk, taccdb)):
        funk = fk.Funk()
        for pk, f in items:
            funk.rec_write(None, pk, ad.Account(**f))
        funk.rec_write(None, k(99), 12345)      # not an Account: ignored
        out.append((funk, ad))
    return out


def test_lthash_of_root_matches_reference():
    items = _accounts(np.random.default_rng(3), 24, zero_every=5)
    (jf, _), (tf, _) = _funks(items)
    got = tbh.lthash_of_root(tf, device="cpu")
    assert np.array_equal(got, jbh.lthash_of_root(jf))
    assert np.array_equal(got, tbh.accounts_lthash(
        [(pk, taccdb.Account(**f)) for pk, f in items], device="cpu"))


def test_bank_hasher_chain_matches_reference():
    """Three slots of deltas on both packages' funk: each slot modifies,
    deletes (zero lamports) and creates accounts in a prepared fork; the
    lattice after apply_txn_delta, its checksum and the chained bank
    hashes are equal, the lanes wrap mod 2^16, and the delta path
    equals a full recompute of the published root."""
    rng = np.random.default_rng(11)
    items = _accounts(rng, 12)
    funks = _funks(items)
    hashers = [jbh.BankHasher(jbh.lthash_of_root(funks[0][0])),
               tbh.BankHasher(tbh.lthash_of_root(funks[1][0], "cpu"),
                              device="cpu")]
    keys = [pk for pk, _ in items] + [rng.bytes(32) for _ in range(6)]
    parents = [bytes(32), bytes(32)]
    for slot in range(3):
        edits = []
        for _ in range(8):
            key = keys[int(rng.integers(0, len(keys)))]
            lam = 0 if rng.random() < 0.2 else int(rng.integers(1, 1 << 50))
            edits.append((key, dict(lamports=lam,
                                    data=rng.bytes(int(rng.integers(0, 90))),
                                    owner=rng.bytes(32))))
        sig_cnt, tip = int(rng.integers(0, 50)), rng.bytes(32)
        for i, ((funk, ad), h) in enumerate(zip(funks, hashers)):
            funk.txn_prepare(None, ("slot", slot))
            for key, f in edits:
                funk.rec_write(("slot", slot), key, ad.Account(**f))
            h.apply_txn_delta(funk, ("slot", slot))
            funk.txn_publish(("slot", slot))
            parents[i] = h.bank_hash(parents[i], sig_cnt, tip)
        assert np.array_equal(hashers[1].acc, hashers[0].acc), slot
        assert hashers[1].checksum() == hashers[0].checksum()
        assert parents[1] == parents[0]
        assert np.array_equal(hashers[1].acc,
                              tbh.lthash_of_root(funks[1][0], "cpu"))
    # wrapping: the lattice of a sum is the wrapped sum of the lattices
    a = tbh.accounts_lthash([(pk, taccdb.Account(**f))
                             for pk, f in items[:6]], "cpu")
    b = tbh.accounts_lthash([(pk, taccdb.Account(**f))
                             for pk, f in items[6:]], "cpu")
    both = tbh.accounts_lthash([(pk, taccdb.Account(**f))
                                for pk, f in items], "cpu")
    assert np.array_equal(
        (a.astype(np.int64) + b) % 65536, both.astype(np.int64))


def test_apply_delta_matches_reference_on_raw_items():
    rng = np.random.default_rng(21)
    old, new = _accounts(rng, 9, 3), _accounts(rng, 9, 4)
    got, want = tbh.BankHasher(device="cpu"), jbh.BankHasher()
    got.apply_delta([(pk, taccdb.Account(**f)) for pk, f in old],
                    [(pk, taccdb.Account(**f)) for pk, f in new])
    want.apply_delta([(pk, jaccdb.Account(**f)) for pk, f in old],
                     [(pk, jaccdb.Account(**f)) for pk, f in new])
    assert np.array_equal(got.acc, want.acc)
    assert got.bank_hash(k(5), 3, k(6)) == want.bank_hash(k(5), 3, k(6))
