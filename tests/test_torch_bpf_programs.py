"""Deployed sBPF programs in the port's executor
(firedancer_tpu_torch/svm/programs.py `_exec_bpf`: the input ABIs, the
lamports write-back under conservation and the ownership rule, the
compute-budget requests, the shared meter) against the JAX package's,
through both executors side by side (tests/torch_svm_parity.py):

* tests/test_bpf_programs.py's programs (mover, minter, a non-zero exit,
  a fault, duplicate account indices, the victim drain, a non-executable
  account);
* SetComputeUnitLimit and RequestHeapFrame as the meter and the heap
  see them;
* the workload's sBPF family (tools/sbpf_family.py at a small size:
  genesis programs under loader v3 and BPF_LOADER_ID, the deploy
  sequence, the upgrade, every invocation and designed failure) slot by
  slot, then its own arithmetic on the port's fork.
Status, fee, logs, return data and every account of the fork equal
(exact)."""
import struct

import pytest

from firedancer_tpu_torch.pack.cost import COMPUTE_BUDGET_PROGRAM_ID
from firedancer_tpu_torch.svm import programs as tprog
from firedancer_tpu_torch.tools import general_exec as gx
from firedancer_tpu_torch.tools import sbpf_family
from firedancer_tpu_torch.vm import asm
from firedancer_tpu_torch.vm.elf import murmur3_32
from test_bpf_programs import STRIDE, minter_prog, mover_prog
from torch_svm_parity import Both, fork_state, k, txn

PAYER, A1, A2, PROG = k(1), k(2), k(3), k(9)
LAM = [2 + i * STRIDE + 32 for i in range(3)]


def env():
    b = Both({PAYER: 1_000_000, A1: dict(lamports=500, owner=PROG),
              A2: dict(lamports=50, owner=PROG), k(7): 900},
             enforce_rent=False)
    return b


def deploy(b, code, executable=True):
    b.write(PROG, lamports=1, data=code, owner=tprog.BPF_LOADER_ID,
            executable=executable)


DUP_MINT = asm(f"""
    mov64 r6, r1
    mov64 r2, 0
    stxdw [r6+{LAM[0]}], r2
    mov64 r2, 500
    stxdw [r6+{LAM[1]}], r2
    ldxdw r3, [r6+{LAM[2]}]
    add64 r3, 500
    stxdw [r6+{LAM[2]}], r3
    mov64 r0, 0
    exit""")
DUP_MOVE = asm(f"""
    mov64 r6, r1
    ldxdw r2, [r6+{LAM[0]}]
    sub64 r2, 100
    stxdw [r6+{LAM[0]}], r2
    stxdw [r6+{LAM[1]}], r2
    ldxdw r3, [r6+{LAM[2]}]
    add64 r3, 100
    stxdw [r6+{LAM[2]}], r3
    mov64 r0, 0
    exit""")

# name -> (code, instruction accounts, first extra account, executable,
# expected status)
CASES = {
    "moves_lamports": (mover_prog(100), [1, 2], A1, True, "ok"),
    "cannot_mint": (minter_prog(777), [1, 2], A1, True,
                    "sum_of_lamports_changed"),
    "nonzero_return": (asm("mov64 r0, 1; exit"), [1, 2], A1, True,
                       "program_failed"),
    "fault": (asm("mov64 r1, 0; ldxdw r0, [r1+0]; exit"), [1, 2], A1,
              True, "program_failed"),
    "duplicates_cannot_mint": (DUP_MINT, [1, 1, 2], A1, True,
                               "sum_of_lamports_changed"),
    "duplicates_consistent_move": (DUP_MOVE, [1, 1, 2], A1, True, "ok"),
    "victim_drain": (mover_prog(100), [1, 2], k(7), True,
                     "invalid_account_owner"),
    "read_only_credit": (mover_prog(100), [1, 2], A1, True,
                         "account_not_writable"),
    "not_executable": (asm("mov64 r0, 0; exit"), [1, 2], A1, False,
                       "unknown_program"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_raw_program_matches_reference(name):
    code, accts, first, exe, want = CASES[name]
    b = env()
    deploy(b, code, exe)
    n_ro = 2 if name == "read_only_credit" else 1
    assert b.run(txn([PAYER], [first, A2, PROG], [(3, accts, b"")],
                     n_ro_unsigned=n_ro, blockhash=b"\x33" * 32)) == want


def _budget_txn(cb_ixs, code_ix=(1, [], b"")):
    return txn([PAYER], [PROG, COMPUTE_BUDGET_PROGRAM_ID],
               [(2, [], d) for d in cb_ixs] + [code_ix], n_ro_unsigned=2)


SPIN = asm("""
    mov64 r2, 200
    sub64 r2, 1
    jne r2, 0, -2
    mov64 r0, 0
    exit""")
HEAP_TOUCH = asm(f"""
    lddw r1, {0x3_0000_0000 + 40 * 1024}
    stb [r1+0], 1
    mov64 r0, 0
    exit""")


@pytest.mark.parametrize("cb,code,want", [
    ([], SPIN, "ok"),
    ([bytes([2]) + struct.pack("<I", 300)], SPIN, "program_failed"),
    ([bytes([2]) + struct.pack("<I", 500)], SPIN, "ok"),
    ([], HEAP_TOUCH, "program_failed"),
    ([bytes([1]) + struct.pack("<I", 64 * 1024)], HEAP_TOUCH, "ok"),
    ([bytes([2]) + struct.pack("<I", 300)] * 2, SPIN,
     "bad_instruction_data"),
])
def test_compute_budget_requests_match_reference(cb, code, want):
    """SetComputeUnitLimit meters the VM (a 200-iteration loop needs
    about 400 units), RequestHeapFrame sizes the heap, a duplicate
    request fails the txn before dispatch."""
    b = env()
    deploy(b, code)
    assert b.run(_budget_txn(cb)) == want


def test_meter_is_shared_across_instructions():
    """Two instructions of one txn draw on one limit: each alone fits
    500 units, together they do not."""
    b = env()
    deploy(b, SPIN)
    lim = bytes([2]) + struct.pack("<I", 500)
    assert b.run(_budget_txn([lim])) == "ok"
    assert b.run(txn([PAYER], [PROG, COMPUTE_BUDGET_PROGRAM_ID],
                     [(2, [], lim), (1, [], b""), (1, [], b"")],
                     n_ro_unsigned=2)) == "program_failed"


def test_input_abis_match_reference():
    """A raw program sees the compact input layout (u16 account count
    first); ELF programs' aligned Solana layout is what the sBPF
    family's programs walk (the last test)."""
    b = env()
    log64 = hex(murmur3_32(b"sol_log_64_"))
    deploy(b, asm(f"""
        ldxh r1, [r1+0]
        call {log64}
        mov64 r0, 0
        exit"""))
    _, _, logs, _ = b.result(txn([PAYER], [A1, A2, PROG],
                                 [(3, [1, 2], b"xy")], n_ro_unsigned=1))
    assert logs[0].startswith("0x2 ")


def test_sbpf_family_matches_reference_and_its_arithmetic():
    """The workload's sBPF family at scale 0.1 through both executors,
    slot by slot (a slot's Clock at 100 + its index); then the family's
    oracle on the port's fork: the vault PDAs', escrows' and recipients'
    lamports, the programdata of every program byte for byte, the
    consumed buffers, and each txn's status, return data and log."""
    wl = gx.build(8, 8, tables=2, table_addrs=8, scale=0.1)
    fam = {p for _, p, f in wl.traffic
           if f.startswith("sbpf") or f == "loader"}
    b = Both({key: dict(lamports=a.lamports, data=bytes(a.data),
                        owner=a.owner, executable=a.executable,
                        rent_epoch=a.rent_epoch)
              for key, a in wl.genesis.items()})
    results = {}
    for s in range(sbpf_family.SLOTS):
        b.set(slot=100 + s)
        for slot, p, _ in wl.traffic:
            if slot == s and p in fam:
                status, _, logs, rdata = b.result(p)
                results[p] = (status, rdata, tuple(logs), 0)
    pkg, funk, _ = b.envs[1]
    root = {bytes(key): (v.lamports, bytes(v.data), v.owner, v.executable,
                         v.rent_epoch)
            for key, v in funk.root_items().items()
            if isinstance(v, pkg.accdb.Account)}
    root.update(fork_state(funk, pkg))
    out = wl.sbpf.check(root, results)
    assert out["statuses"]["loader:ok"] == 8
    assert sum(v for key, v in out["statuses"].items()
               if not key.endswith(":ok")) == 6
