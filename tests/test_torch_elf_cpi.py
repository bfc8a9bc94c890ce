"""The port's ELF loader (firedancer_tpu_torch/vm/elf.py) and CPI
(svm/programs.py: invoke_signed, the PDA syscalls, the shared compute
meter) against the JAX package's, and the port's ELF writer
(tools/sbpf_elf.py) against the reference's loader.

* ELF images (tests/test_elf_cpi.py's fixture, the workload's programs)
  and malformed variants of them, seeded: both loaders give the same
  relocated image, entry, call registry and syscalls, or the same
  ElfError.
* The writer's images, loaded by the reference's vm/elf.load: the same
  text as assembled, each relocation applied where the writer put it,
  the entry point at `entrypoint:`.
* The CPI scenarios of tests/test_elf_cpi.py through both executors
  (tests/torch_svm_parity.py), and the escalation, depth and PDA
  syscall cases: status, fee, logs, return data and the fork equal."""
import random
import struct

import pytest

from firedancer_tpu.svm import programs as jprog
from firedancer_tpu.vm import elf as jelf
from firedancer_tpu_torch.svm import programs as tprog
from firedancer_tpu_torch.svm.accdb import SYSTEM_PROGRAM_ID
from firedancer_tpu_torch.tools import sbpf_elf, sbpf_family
from firedancer_tpu_torch.vm import INPUT_START, asm
from firedancer_tpu_torch.vm import elf as telf
from test_elf_cpi import (BUMP, DEST, PAYER, PDA, PROG, SEEDS_BLOB,
                          _build_elf, _cpi_blob, _cpi_prog)
from torch_svm_parity import Both, k, txn

LOADERS = (jelf, telf)


def load_both(img: bytes):
    """-> the port's loaded program fields, or the ElfError text, once
    both loaders agree."""
    got = []
    for mod in LOADERS:
        try:
            p = mod.load(img)
            got.append((p.image, p.text_off, p.text_sz, p.entry_pc,
                        p.calls, p.syscalls_used, p.text))
        except mod.ElfError as e:
            got.append(("ElfError", str(e)))
    assert got[1] == got[0]
    return got[1]


def _images():
    out = {"fixture": _build_elf(), "fixture_em_bpf": _build_elf(
        jelf.EM_BPF)}
    out.update(sbpf_family.elfs())
    return out


IMAGES = _images()


def test_constants_and_hashes_match_reference():
    for name in ("EM_BPF", "EM_SBPF", "R_BPF_64_64", "R_BPF_64_RELATIVE",
                 "R_BPF_64_32", "MM_PROGRAM_START"):
        assert getattr(telf, name) == getattr(jelf, name)
    rng = random.Random(19)
    for n in range(64):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert telf.murmur3_32(data, n) == jelf.murmur3_32(data, n)
        assert telf.pc_hash(n * 977) == jelf.pc_hash(n * 977)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_loader_matches_reference(name):
    got = load_both(IMAGES[name])
    assert got[0] != "ElfError"


def _mutations(img: bytes, seed: int):
    rng = random.Random(seed)
    yield "bad_machine", img[:18] + struct.pack("<H", 62) + img[20:]
    yield "entry_in_ehdr", img[:24] + struct.pack("<Q", 8) + img[32:]
    yield "no_sections", img[:40] + bytes(8) + img[48:]
    yield "shstrndx", img[:62] + struct.pack("<H", 99) + img[64:]
    yield "elf32", img[:4] + b"\x01" + img[5:]
    yield "not_elf", b"\x7fELG" + img[4:]
    for cut in (16, 63, len(img) // 2, len(img) - 1):
        yield f"truncated_{cut}", img[:cut]
    for i in range(24):
        b = bytearray(img)
        for _ in range(rng.randrange(1, 4)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        yield f"flip_{i}", bytes(b)


@pytest.mark.parametrize("name", ["fixture", "vault", "hash"])
def test_malformed_images_match_reference(name):
    """Seeded corruptions: both loaders load the same program or raise
    the same ElfError; neither raises anything else."""
    for what, img in _mutations(IMAGES[name], 19):
        try:
            load_both(img)
        except AssertionError:
            raise AssertionError(f"{name}/{what}")


@pytest.mark.parametrize("name", ["vault", "hash", "spin", "curve"])
def test_elf_writer_images_load_as_assembled(name):
    """The workload's program through tools/sbpf_elf and the reference's
    vm/elf.load: the text is the assembled text with the relocations the
    writer emitted applied (syscall names' murmur3, defined functions'
    pc hashes in the call registry, .rodata addresses), and the entry is
    the `entrypoint:` label's pc."""
    src = {"vault": sbpf_family.VAULT, "spin": sbpf_family.SPIN,
           "curve": sbpf_family.CURVE,
           "hash": sbpf_family._hash_src(1, sbpf_family.HASH_LINES[1])}[name]
    text, labels, rodata_rel, call_rel = sbpf_elf.assemble(src)
    prog = jelf.load(IMAGES[name])
    assert prog.entry_pc == labels["entrypoint"]
    assert prog.text_sz == len(text) and prog.text_off == 64
    rodata_off = 64 + len(text)
    want = bytearray(text)
    for pc, off in rodata_rel:
        va = jelf.MM_PROGRAM_START + rodata_off + off
        struct.pack_into("<I", want, pc * 8 + 4, va & 0xFFFFFFFF)
        struct.pack_into("<I", want, pc * 8 + 12, va >> 32)
    syscalls = set()
    for pc, sym, is_label in call_rel:
        if is_label:
            h = jelf.pc_hash(labels[sym])
            assert prog.calls[h] == labels[sym]
        else:
            h = jelf.murmur3_32(sym.encode())
            syscalls.add(sym)
        struct.pack_into("<I", want, pc * 8 + 4, h)
    assert prog.text == bytes(want)
    assert prog.syscalls_used == syscalls
    assert {"walk"} <= {s for _, s, lab in call_rel if lab}
    load_both(IMAGES[name])


def test_elf_writer_jumps_and_labels():
    """Labels resolve to pc-relative jump offsets (lddw spans two
    slots); numeric forms pass through as vm/asm.py writes them."""
    text, labels, _, _ = sbpf_elf.assemble("""
        entrypoint:
            lddw r1, 5
            jeq r1, 5, out
            ja entrypoint
        out:
            mov64 r0, 7
            exit
    """)
    assert labels == {"entrypoint": 0, "out": 4}
    assert text == asm("lddw r1, 5; jeq r1, 5, +1; ja -4; mov64 r0, 7; "
                       "exit")


def _cpi_env(pda_lamports=1000):
    b = Both({PAYER: 1_000_000}, enforce_rent=False)
    b.write(PDA, lamports=pda_lamports)
    return b


def _deploy_raw(b, key, code):
    b.write(key, lamports=1, data=code, owner=tprog.BPF_LOADER_ID,
            executable=True)


@pytest.mark.parametrize("case", ["pda_signer", "wrong_seeds",
                                  "no_seeds", "insufficient",
                                  "writable_escalation",
                                  "account_not_in_caller"])
def test_cpi_matches_reference(case):
    """tests/test_elf_cpi.py's CPI cases (a system transfer PDA -> DEST
    signed by seeds) and two escalations: a callee meta asking writable
    for an account the caller has read-only, and one naming an account
    the caller does not hold."""
    b = _cpi_env()
    amount = 10_000 if case == "insufficient" else 500
    seeds = {"wrong_seeds": bytes([1, 1, 4]) + b"evil",
             "no_seeds": bytes([0])}.get(case, SEEDS_BLOB)
    ix, sd = _cpi_blob(amount, True, seeds)
    extra, n_ro = [PDA, DEST], 1
    if case == "writable_escalation":
        extra, n_ro = [PDA, DEST], 2         # DEST read-only in the txn
    if case == "account_not_in_caller":
        ix = ix.replace(DEST, k(0x44))
    _deploy_raw(b, PROG, _cpi_prog(2, len(ix)))
    p = txn([PAYER], extra + [PROG], [(3, [1, 2], ix + sd)],
            n_ro_unsigned=n_ro)
    status, fee, logs, _ = b.result(p)
    want = "ok" if case == "pda_signer" else "program_failed"
    assert status == want, logs
    if case == "pda_signer":
        assert b.account(PDA).lamports == 500
        assert b.account(DEST).lamports == 500


def test_cpi_return_data_propagates():
    b = _cpi_env()
    prog_b = k(0x0B)
    _deploy_raw(b, prog_b, asm(f"""
        lddw r1, {INPUT_START + 4}
        mov64 r2, 6
        call {hex(telf.murmur3_32(b"sol_set_return_data"))}
        mov64 r0, 0
        exit"""))
    ix = prog_b + struct.pack("<H", 0) + struct.pack("<H", 6) + b"from-B"
    data_va = INPUT_START + 4
    _deploy_raw(b, PROG, asm(f"""
        lddw r1, {data_va}
        lddw r2, {data_va + len(ix)}
        call {hex(telf.murmur3_32(b"sol_invoke_signed_c"))}
        mov64 r0, 0
        exit"""))
    status, _, _, rdata = b.result(txn([PAYER], [PROG], [
        (1, [], ix + bytes([0]))], n_ro_unsigned=1))
    assert status == "ok" and rdata == b"from-B"


def test_cpi_depth_limit_matches_reference(monkeypatch):
    """A program that invokes itself with its own instruction data (its
    id): frames nest until MAX_CPI_DEPTH refuses the next and the whole
    txn fails alike in both packages; the port's frames reached the
    deepest depth the limit allows."""
    b = _cpi_env()
    heap = 0x3_0000_0000
    memcpy = hex(telf.murmur3_32(b"sol_memcpy_"))
    _deploy_raw(b, PROG, asm(f"""
        lddw r1, {heap}
        lddw r2, {INPUT_START + 4}
        mov64 r3, 32
        call {memcpy}
        lddw r1, {heap + 36}
        lddw r2, {INPUT_START + 4}
        mov64 r3, 32
        call {memcpy}
        lddw r6, {heap}
        sth [r6+34], 32
        mov64 r1, r6
        mov64 r2, 0
        call {hex(telf.murmur3_32(b"sol_invoke_signed_c"))}
        mov64 r0, 0
        exit"""))
    depths = []
    inner = tprog.dispatch_instr

    def seen(ctx, ic, depth=0, budget=None):
        depths.append(depth)
        return inner(ctx, ic, depth, budget)
    monkeypatch.setattr(tprog, "dispatch_instr", seen)
    status, _, _, _ = b.result(txn([PAYER], [PROG], [(1, [], PROG)],
                                   n_ro_unsigned=1))
    assert status == "program_failed"
    assert max(depths) == tprog.MAX_CPI_DEPTH - 1 == \
        jprog.MAX_CPI_DEPTH - 1


def test_pda_syscalls_match_reference():
    """sol_create_program_address and sol_try_find_program_address from
    a raw program: the derived address and bump written to the input
    region, logged with sol_log_64 by both packages alike."""
    b = _cpi_env()
    seed = b"vault"
    # input (compact): u16 0 accounts | u16 dlen | data = seed | pid
    data = seed + PROG
    d0 = INPUT_START + 4
    sid = {n: hex(telf.murmur3_32(n)) for n in (
        b"sol_create_program_address", b"sol_try_find_program_address",
        b"sol_log_64_", b"sol_log_")}
    _deploy_raw(b, PROG, asm(f"""
        lddw r1, {d0}
        stxdw [r10-16], r1
        mov64 r1, 5
        stxdw [r10-8], r1
        mov64 r1, r10
        add64 r1, -16
        mov64 r2, 1
        lddw r3, {d0 + 5}
        mov64 r4, r10
        add64 r4, -64
        mov64 r5, r10
        add64 r5, -72
        call {sid[b"sol_try_find_program_address"]}
        mov64 r6, r0
        ldxb r7, [r10-72]
        mov64 r1, r10
        add64 r1, -64
        mov64 r2, 32
        call {sid[b"sol_log_"]}
        mov64 r1, r6
        mov64 r2, r7
        mov64 r3, 0
        mov64 r4, 0
        mov64 r5, 0
        call {sid[b"sol_log_64_"]}
        mov64 r1, r10
        add64 r1, -16
        mov64 r2, 17
        lddw r3, {d0 + 5}
        mov64 r4, r10
        add64 r4, -64
        call {sid[b"sol_create_program_address"]}
        exit"""))
    status, _, logs, _ = b.result(txn([PAYER], [PROG], [
        (1, [], data)], n_ro_unsigned=1))
    assert status == "program_failed"         # r0 = 1: 17 seeds refused
    addr, bump = tprog.find_program_address([seed], PROG)
    assert logs[-1] == f"0x0 {bump:#x} 0x0 0x0 0x0"
    assert logs[0] == addr.decode("utf-8", "replace")


def test_pda_derivation_matches_reference():
    rng = random.Random(19)
    for i in range(16):
        seeds = [bytes(rng.randrange(256) for _ in range(rng.randrange(33)))
                 for _ in range(rng.randrange(4))]
        pid = bytes(rng.randrange(256) for _ in range(32))
        assert tprog.find_program_address(seeds, pid) == \
            jprog.find_program_address(seeds, pid)
        assert tprog.create_program_address(seeds, pid) == \
            jprog.create_program_address(seeds, pid)
    assert tprog.create_program_address([b"x" * 33], PROG) is None
    assert tprog.find_program_address([b"vault"], PROG) == (PDA, BUMP)
    assert SYSTEM_PROGRAM_ID == bytes(32)
