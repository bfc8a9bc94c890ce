"""The port's host executor (firedancer_tpu_torch/svm/programs.py: the
system program with its seed and nonce accounts, ComputeBudget, the fee
and rent discipline) and sysvar accounts (svm/sysvars.py) against the
JAX package's, on the same accounts and transactions: statuses, fees,
logs, return data and every account of the fork equal (exact). The vote,
stake, lookup-table and precompile programs, v0 transactions, the
upgradeable loader and deployed sBPF programs have parity files of their
own (test_torch_conformance.py, test_torch_vote_program.py,
test_torch_loader.py, test_torch_bpf_programs.py, ...)."""
import struct

import numpy as np
import pytest

from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu.protocol.txn import build_message, build_txn
from firedancer_tpu.svm import accdb as jaccdb
from firedancer_tpu.svm import programs as jprog
from firedancer_tpu.svm import sysvars as jsys
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.pack.cost import COMPUTE_BUDGET_PROGRAM_ID
from firedancer_tpu_torch.svm import accdb as taccdb
from firedancer_tpu_torch.svm import programs as tprog
from firedancer_tpu_torch.svm import sysvars as tsys

SYS = bytes(32)
PKGS = ((jfunk, jaccdb, jprog), (tfunk, taccdb, tprog))


def k(n):
    return bytes([n]) * 32


def txn(signers, extra, instrs, n_ro_unsigned=0, **kw):
    """Unsigned-signature txn (the executor does not re-verify
    signatures: the verify tile did)."""
    return build_txn([bytes(64)] * len(signers), build_message(
        signers, extra, b"\x11" * 32, instrs, n_ro_unsigned=n_ro_unsigned,
        **kw))


def ix(prog_idx, accts, disc, *fields):
    data = struct.pack("<I", disc)
    for f in fields:
        if isinstance(f, tuple):                 # bincode string
            data += struct.pack("<Q", len(f[1])) + f[1]
        else:
            data += f if isinstance(f, bytes) else struct.pack("<Q", f)
    return (prog_idx, list(accts), data)


class Both:
    """The reference's and the port's executor, each over its own Funk
    holding the same root accounts and one prepared fork "blk"."""

    def __init__(self, accounts, enforce_rent=True):
        self.envs = []
        for fk, ad, pg in PKGS:
            funk = fk.Funk()
            for key, a in accounts.items():
                funk.rec_write(None, key, ad.Account(**a))
            funk.txn_prepare(None, "blk")
            self.envs.append((funk, ad, pg.TxnExecutor(
                ad.AccDb(funk), enforce_rent=enforce_rent)))

    def write(self, key, **a):
        for funk, ad, _ in self.envs:
            funk.rec_write("blk", key, ad.Account(**a))

    def slot(self, slot, **kw):
        for _, _, ex in self.envs:
            ex.begin_slot("blk", slot, **kw)

    def set_slot(self, slot):
        for _, _, ex in self.envs:
            ex.slot = slot

    def run(self, payload):
        """Execute on both; the results and the fork's accounts must be
        equal. -> the status."""
        got = []
        for funk, ad, ex in self.envs:
            r = ex.execute("blk", payload)
            accts = {key: (v.lamports, bytes(v.data), v.owner,
                           v.executable, v.rent_epoch)
                     for key, v in funk.items_at("blk").items()
                     if isinstance(v, ad.Account)}
            got.append(((r.status, r.fee, list(r.logs), r.return_data),
                         accts))
        assert got[1] == got[0]
        return got[1][0][0]


RICH = {k(1): dict(lamports=10**9)}


def _transfer(b):
    assert b.run(txn([k(1)], [k(2), SYS], [ix(2, [0, 1], 2, 10**7)])) \
        == "ok"
    # a failing second instruction rolls the first back, the fee stays
    assert b.run(txn([k(1)], [k(2), SYS], [
        ix(2, [0, 1], 2, 100), ix(2, [0, 1], 2, 10**12)])) \
        == "insufficient_funds"


def _fee_and_rent(b):
    b.write(k(3), lamports=10)
    assert b.run(txn([k(3)], [k(2), SYS], [ix(2, [0, 1], 2, 1)])) \
        == "fee_payer_insufficient"
    # the fee would leave an exempt payer rent-paying: refused at load
    b.write(k(4), lamports=tsys.rent_exempt_minimum(0) + 1000)
    assert b.run(txn([k(4)], [k(2), SYS], [ix(2, [0, 1], 2, 1)])) \
        == "insufficient_funds_for_rent"
    # a new account funded below the exempt minimum
    assert b.run(txn([k(1)], [k(6), SYS], [ix(2, [0, 1], 2, 5)])) \
        == "insufficient_funds_for_rent"


def _create_assign_allocate(b):
    create = txn([k(1), k(5)], [SYS], [ix(2, [0, 1], 0, 10**7, 64, k(9))])
    assert b.run(create) == "ok"
    assert b.run(create) == "account_already_in_use"
    assert b.run(txn([k(1)], [k(5), SYS], [ix(2, [0, 1], 0, 10**7, 0,
                                              k(9))])) \
        == "missing_required_signature"
    b.write(k(7), lamports=10**8)
    assert b.run(txn([k(7)], [SYS], [ix(1, [0], 8, 32),
                                     ix(1, [0], 1, k(7))])) == "ok"
    # now data-bearing and foreign-owned: no more transfers out
    assert b.run(txn([k(7)], [k(2), SYS], [ix(2, [0, 1], 2, 1)])) \
        == "invalid_account_owner"
    b.write(k(8), lamports=10**8, data=b"xy")
    assert b.run(txn([k(8)], [k(2), SYS], [ix(2, [0, 1], 2, 1)])) \
        == "account_has_data"
    # Assign of a signer the message gives read-only, then writable
    assert b.run(txn([k(1), k(11)], [SYS], [ix(2, [1], 1, k(7))],
                     n_ro_signed=1, n_ro_unsigned=1)) \
        == "account_not_writable"
    assert b.run(txn([k(1), k(11)], [SYS], [ix(2, [1], 1, k(7))],
                     n_ro_unsigned=1)) == "ok"


def _seeds(b):
    derived = tprog.create_with_seed(k(1), b"vault", SYS)
    assert derived == jprog.create_with_seed(k(1), b"vault", SYS)
    assert b.run(txn([k(1)], [derived, SYS], [ix(
        2, [0, 1], 3, k(1), ("s", b"vault"), 10**7, 0, SYS)],
        n_ro_unsigned=1)) == "ok"
    assert b.run(txn([k(1)], [derived, SYS], [ix(
        2, [0, 1], 3, k(1), ("s", b"other"), 10**7, 0, SYS)],
        n_ro_unsigned=1)) == "invalid_account_owner"
    assert b.run(txn([k(1)], [derived, k(5), SYS], [ix(
        3, [1, 0, 2], 11, 2_500, ("s", b"vault"), SYS)],
        n_ro_unsigned=1)) == "ok"
    other = tprog.create_with_seed(k(1), b"x", k(9))
    b.write(other, lamports=10**7)
    assert b.run(txn([k(1)], [other, SYS], [ix(
        2, [1], 9, k(1), ("s", b"x"), 16, k(9))], n_ro_unsigned=1)) == "ok"
    assert b.run(txn([k(1)], [other, SYS], [ix(
        2, [1], 10, k(1), ("s", b"x"), k(9))], n_ro_unsigned=1)) \
        == "invalid_account_owner"
    assert b.run(txn([k(1)], [derived, SYS], [ix(
        2, [0, 1], 3, k(1), ("s", b"v" * 40), 1, 0, SYS)],
        n_ro_unsigned=1)) == "bad_instruction_data"


def _nonce(b):
    sz = tprog.NONCE_STATE_SZ
    b.write(k(4), lamports=tsys.rent_exempt_minimum(sz) + 20_000,
            data=bytes(sz))
    b.set_slot(9)
    assert b.run(txn([k(1), k(4)], [SYS], [
        (2, [1], struct.pack("<I", 6) + k(1))])) == "ok"
    # advancing in the slot it was initialized in does not move it
    assert b.run(txn([k(1)], [k(4), SYS], [ix(2, [1], 4)])) \
        == "bad_instruction_data"
    b.set_slot(10)
    assert b.run(txn([k(1)], [k(4), SYS], [ix(2, [1], 4)])) == "ok"
    # the authority must sign
    b.write(k(2), lamports=10**8)
    assert b.run(txn([k(2)], [k(4), SYS], [ix(2, [1], 4)])) \
        == "missing_required_signature"
    assert b.run(txn([k(1)], [k(4), SYS], [(2, [1], struct.pack(
        "<I", 7) + k(3))])) == "ok"
    b.write(k(3), lamports=10**8)
    # partial withdraw must keep the reserve; a full one closes
    assert b.run(txn([k(3)], [k(4), k(5), SYS], [ix(3, [1, 2], 5,
                                                    25_000)])) \
        == "insufficient_funds"
    assert b.run(txn([k(3)], [k(4), k(5), SYS], [ix(3, [1, 2], 5,
                                                    10_000)])) == "ok"
    full = tsys.rent_exempt_minimum(sz) + 10_000
    assert b.run(txn([k(3)], [k(4), k(5), SYS], [ix(3, [1, 2], 5, full)])) \
        == "ok"
    # an uninitialized nonce-sized account withdraws by its own signature
    b.write(k(12), lamports=tsys.rent_exempt_minimum(sz), data=bytes(sz))
    assert b.run(txn([k(1), k(12)], [k(5), SYS], [ix(
        3, [1, 2], 5, tsys.rent_exempt_minimum(sz))])) == "ok"


def _compute_budget_and_bad_input(b):
    cb = bytes([2]) + (100).to_bytes(4, "little")
    assert b.run(txn([k(1)], [k(2), COMPUTE_BUDGET_PROGRAM_ID, SYS], [
        (2, [], cb), ix(3, [0, 1], 2, 10**7)], n_ro_unsigned=2)) == "ok"
    assert b.run(txn([k(1)], [COMPUTE_BUDGET_PROGRAM_ID], [
        (1, [], b"\xff\x01")], n_ro_unsigned=1)) == "bad_instruction_data"
    assert b.run(b"\x01" + bytes(10)) == "parse_failed"
    assert b.run(txn([k(1)], [k(13)], [(1, [0], b"")],
                     n_ro_unsigned=1)) == "unknown_program"
    assert b.run(txn([k(1)], [SYS], [(1, [0], b"\x02")],
                     n_ro_unsigned=1)) == "bad_instruction_data"
    assert b.run(txn([k(1)], [SYS], [(1, [0], struct.pack("<I", 99))],
                     n_ro_unsigned=1)) == "unknown_instruction"
    for _ in range(3):
        assert b.run(txn([k(1)], [k(2), SYS], [ix(2, [0, 1], 2, 10**13)])) \
            == "insufficient_funds"


SCENARIOS = {
    "transfer_and_rollback": (_transfer, False),
    "fee_and_rent_failures": (_fee_and_rent, True),
    "create_assign_allocate": (_create_assign_allocate, False),
    "seed_accounts": (_seeds, False),
    "nonce_lifecycle": (_nonce, False),
    "compute_budget_and_bad_input": (_compute_budget_and_bad_input, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_system_program_matches_reference(name):
    fn, rent = SCENARIOS[name]
    fn(Both(RICH, enforce_rent=rent))


@pytest.mark.parametrize("slot,spe", [(0, 432_000), (7, 432_000),
                                      (432_001, 432_000), (33, 32)])
def test_begin_slot_sysvar_bytes_match_reference(slot, spe):
    """begin_slot writes Clock, Rent and EpochSchedule (bank-hash lattice
    inputs) byte for byte as the reference's; with a blockhash also
    SlotHashes and RecentBlockhashes."""
    b = Both(RICH)
    b.slot(slot, slots_per_epoch=spe)
    b.slot(slot + 1, slots_per_epoch=spe, blockhash=b"\x07" * 32)
    states = []
    for funk, ad, _ in b.envs:
        states.append({key: (v.lamports, bytes(v.data), v.owner)
                       for key, v in funk.items_at("blk").items()
                       if isinstance(v, ad.Account)})
    assert states[1] == states[0]
    for name in ("CLOCK_ID", "RENT_ID", "EPOCH_SCHEDULE_ID",
                 "SLOT_HASHES_ID", "RECENT_BLOCKHASHES_ID"):
        assert getattr(tsys, name) == getattr(jsys, name)
        assert getattr(tsys, name) in states[1]
    assert tsys.dec_clock(states[1][tsys.CLOCK_ID][1])["slot"] == slot + 1
    assert tsys.enc_stake_history([(3, (1, 2, 3))]) == \
        jsys.enc_stake_history([(3, (1, 2, 3))])


def test_accdb_handles_match_reference():
    """The AccDb facade: peek of a bare-int record, open_ro/open_rw
    copies, do_create, close_rw landing in the fork, discard, the
    double-close guard and the active-handle counts."""
    out = []
    for fk, ad, _ in PKGS:
        funk = fk.Funk()
        funk.rec_write(None, k(1), 77)
        funk.txn_prepare(None, "x")
        db = ad.AccDb(funk)
        a = db.peek("x", k(1))
        ro = db.open_ro("x", k(1))
        ro.lamports = 5
        h = db.open_rw("x", k(2), do_create=True)
        h.account.lamports = 9
        db.close_rw(h)
        with pytest.raises(RuntimeError):
            db.close_rw(h)
        h2 = db.open_rw("x", k(1))
        h2.account.lamports = 1
        db.close_rw(h2, discard=True)
        db.close_ro(ro)
        db.set_lamports("x", k(3), 4)
        out.append((a.lamports, db.open_rw("x", k(4)), db.lamports("x", k(1)),
                    db.lamports("x", k(2)), db.lamports("x", k(3)),
                    db.ro_active, db.rw_active, h.created))
    assert out[1] == out[0] == (77, None, 77, 9, 4, 0, 0, True)
    assert taccdb.DEPTH_MAX == jaccdb.DEPTH_MAX


def test_log_collector_truncates_as_the_reference():
    got = []
    for _, _, pg in PKGS:
        lc = pg.LogCollector()
        for i in range(2000):
            lc.append(f"line {i}")
        got.append(list(lc))
    assert got[1] == got[0] and got[1][-1] == "Log truncated"
    assert np.sum([len(x) for x in got[1][:-1]]) \
        <= tprog.LogCollector.MAX_BYTES
