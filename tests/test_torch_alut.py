"""The port's address lookup table program and v0 execution
(firedancer_tpu_torch/svm/alut.py's write half, svm/programs.py's
TxnExecutor.execute through `resolve_loaded_keys`) against the JAX
package's: the cases of tests/test_alut.py, each run through both
packages' executors on the same accounts with equal statuses, fees, logs
and byte-equal accounts (tests/torch_svm_parity.Both)."""
import struct

import pytest

from firedancer_tpu.protocol.txn import parse_txn
from torch_svm_parity import JAX, PKGS, TORCH, Both, k, txn

PAYER = k(1)
LOOKED_UP = [k(0x41), k(0x42), k(0x43)]
ALUT, SYS = TORCH.alut.ALUT_PROGRAM_ID, bytes(32)


@pytest.fixture
def b():
    return Both({PAYER: 1 << 30}, enforce_rent=False, slot=100)


def _create_and_extend(b, addresses, recent=90):
    table, bump = TORCH.alut.derive_table_address(PAYER, recent)
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], TORCH.alut.ix_create(recent, bump))],
                     n_ro_unsigned=1)) == "ok"
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], TORCH.alut.ix_extend(addresses))],
                     n_ro_unsigned=1)) == "ok"
    return table


def _v0_transfer(table, w=(1,), ro=(), amount=999):
    return txn([PAYER], [SYS], [(1, [0, 2], struct.pack("<IQ", 2, amount))],
               n_ro_unsigned=1, version=0,
               aluts=[(table, bytes(w), bytes(ro))])


def test_instruction_data_and_derivation_match_reference():
    for pkg_fn, args in (("ix_create", (90, 254)),
                         ("ix_extend", (LOOKED_UP,)),
                         ("ix_deactivate", ()), ("ix_close", ()),
                         ("derive_table_address", (PAYER, 90)),
                         ("derive_table_address", (k(9), 1 << 40))):
        assert getattr(TORCH.alut, pkg_fn)(*args) == \
            getattr(JAX.alut, pkg_fn)(*args)
    st = [p.alut.AlutState(k(5), 77, 3, 1, LOOKED_UP) for p in PKGS]
    assert st[1].to_bytes() == st[0].to_bytes()


def test_create_extend_state(b):
    table = _create_and_extend(b, LOOKED_UP)
    st = TORCH.alut.AlutState.from_bytes(b.account(table).data)
    assert st.addresses == LOOKED_UP and st.authority == PAYER
    assert st.deactivation_slot == TORCH.alut.SLOT_MAX
    assert st.last_extended_slot == 100
    # extending past MAX_ADDRESSES and creating twice are refused
    full = TORCH.alut.AlutState(PAYER, addresses=[k(9)] * 255)
    b.write(table, lamports=0, data=full.to_bytes(), owner=ALUT)
    assert b.run(txn([PAYER], [table, ALUT], [(2, [1, 0], TORCH.alut
                 .ix_extend([k(9)] * 2))], n_ro_unsigned=1)) == \
        "bad_instruction_data"
    _, bump = TORCH.alut.derive_table_address(PAYER, 90)
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], TORCH.alut.ix_create(90, bump))],
                     n_ro_unsigned=1)) == "invalid_account_owner"


def test_create_rejects_wrong_pda(b):
    _, bump = TORCH.alut.derive_table_address(PAYER, 90)
    assert b.run(txn([PAYER], [k(0x77), ALUT],
                     [(2, [1, 0], TORCH.alut.ix_create(90, bump))],
                     n_ro_unsigned=1)) == "invalid_account_owner"


def test_extend_requires_authority_signature(b):
    table = _create_and_extend(b, LOOKED_UP[:1])
    evil = k(0x66)
    b.write(evil, lamports=1 << 30)
    assert b.run(txn([evil], [table, PAYER, ALUT],
                     [(3, [1, 2], TORCH.alut.ix_extend([k(0x55)]))],
                     n_ro_unsigned=2)) == "missing_required_signature"


def test_freeze_blocks_extend(b):
    table = _create_and_extend(b, LOOKED_UP[:2])
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], struct.pack("<I", TORCH.alut.IX_FREEZE))],
                     n_ro_unsigned=1)) == "ok"
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], TORCH.alut.ix_extend([k(9)]))],
                     n_ro_unsigned=1)) == "invalid_account_owner"


def test_v0_txn_executes_through_looked_up_account(b):
    table = _create_and_extend(b, LOOKED_UP)
    t = _v0_transfer(table)
    keys = b.call(lambda pkg, funk: pkg.alut.resolve_loaded_keys(
        pkg.accdb.AccDb(funk), "blk", parse_txn(t), slot=100))
    assert keys == ([LOOKED_UP[1]], [True])
    assert b.run(t) == "ok"
    assert b.account(LOOKED_UP[1]).lamports == 999
    # two tables, writables then readonlys across them
    t2 = _create_and_extend(b, [k(0x51), k(0x52)], recent=91)
    multi = txn([PAYER], [SYS], [(1, [0, 2], struct.pack("<IQ", 2, 5)),
                                 (1, [0, 3], struct.pack("<IQ", 2, 6))],
                n_ro_unsigned=1, version=0,
                aluts=[(table, bytes([0]), bytes([2])),
                       (t2, bytes([1]), b"")])
    assert b.run(multi) == "ok"
    assert b.account(k(0x52)).lamports == 6


def test_v0_loaded_readonly_cannot_be_written(b):
    table = _create_and_extend(b, LOOKED_UP)
    assert b.run(_v0_transfer(table, w=(), ro=(1,))) == \
        "account_not_writable"


@pytest.mark.parametrize("case", ["missing", "index", "foreign"])
def test_v0_unresolvable_table_fails_cleanly(b, case):
    table = _create_and_extend(b, LOOKED_UP)
    if case == "foreign":
        b.write(k(0x78), lamports=5, data=b"\x01" * 60, owner=k(3))
    t = {"missing": _v0_transfer(k(0x77), w=(0,)),
         "index": _v0_transfer(table, w=(7,)),
         "foreign": _v0_transfer(k(0x78), w=(0,))}[case]
    assert b.run(t) == "alut_resolution_failed"
    assert b.account(PAYER).lamports == (1 << 30) - 3 * 5000


def test_deactivate_blocks_resolution_then_close(b):
    table = _create_and_extend(b, LOOKED_UP)
    assert b.run(txn([PAYER], [table, ALUT],
                     [(2, [1, 0], TORCH.alut.ix_deactivate())],
                     n_ro_unsigned=1)) == "ok"
    b.set(slot=200)
    assert b.run(_v0_transfer(table, w=(0,), amount=1)) == \
        "alut_resolution_failed"
    b.write(table, lamports=777, data=b.account(table).data, owner=ALUT)
    assert b.run(txn([PAYER], [table, k(0x50), ALUT],
                     [(3, [1, 0, 2], TORCH.alut.ix_close())],
                     n_ro_unsigned=1)) == "ok"
    assert b.account(k(0x50)).lamports == 777
    assert b.account(table).data == b""
