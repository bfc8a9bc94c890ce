"""The port's sBPF VM (firedancer_tpu_torch/vm/: interp, asm, syscalls,
trace) against the JAX package's vm/, on the same programs and inputs:
the assembler's bytes, then for every run the fault, r0, the compute
units used, the log, the return data and every memory region (rodata,
stack, heap, input) equal (exact). The programs mirror
tests/test_vm.py's scenarios (ALU, jumps, memory faults, calls and the
call depth, the compute meter, syscalls) and tests/test_ristretto.py's
and tests/test_bn254.py's syscall cases; a hypothesis test runs random
instruction streams through both interpreters with a tracer attached
and compares the register file at every step."""
import hashlib
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from firedancer_tpu import vm as jvm
from firedancer_tpu.utils import bn254 as jbn
from firedancer_tpu.utils import ed25519_ref as jed
from firedancer_tpu.utils import ristretto as jrr
from firedancer_tpu.vm import syscalls as jsys
from firedancer_tpu.vm import trace as jtrace
from firedancer_tpu_torch import vm as tvm
from firedancer_tpu_torch.vm import elf as telf
from firedancer_tpu_torch.vm import syscalls as tsys
from firedancer_tpu_torch.vm import trace as ttrace

PKGS = ((jvm, jsys, jtrace), (tvm, tsys, ttrace))
IN = tvm.INPUT_START


def sid(name: bytes) -> str:
    return hex(telf.murmur3_32(name))


def run_both(src, input_data=b"", syscalls=True, sysvars=None,
             trace=False, **kw):
    """Assemble `src` (text or bytes) and run it on both VMs. -> the
    port's (error, r0, compute_used, log, return_data, regions, trace)
    once both agree."""
    got = []
    for vm_mod, sys_mod, tr_mod in PKGS:
        prog = vm_mod.asm(src) if isinstance(src, str) else src
        calls = dict(sys_mod.DEFAULT_SYSCALLS) if syscalls is True \
            else dict(syscalls or {})
        vm = vm_mod.Vm(prog, input_data=input_data, syscalls=calls, **kw)
        if sysvars is not None:
            vm.sysvars = sysvars
        tr = tr_mod.Tracer(limit=1 << 16).attach(vm) if trace else None
        try:
            r = vm.run()
        except IndexError as e:
            # a register field above r10 (raw random bytes) escapes
            # run() as IndexError in the reference too
            got.append((prog, repr(e)))
            continue
        got.append((prog, r.error, r.r0, r.compute_used, list(r.log),
                    getattr(vm, "return_data", None),
                    [bytes(rg.data) for rg in vm.regions],
                    None if tr is None else
                    [(e.pc, e.cu, e.regs, e.text) for e in tr.entries]))
    assert got[1] == got[0]
    return got[1][1:]


def test_exports_and_layout_match_reference():
    for name in ("ERR_ABORT", "ERR_BAD_OP", "ERR_BUDGET", "ERR_DEPTH",
                 "ERR_DIV0", "ERR_NONE", "ERR_OOB", "ERR_PC",
                 "ERR_SYSCALL", "HEAP_START", "INPUT_START",
                 "RODATA_START", "STACK_START"):
        assert getattr(tvm, name) == getattr(jvm, name), name
    assert sorted(tsys.DEFAULT_SYSCALLS) == sorted(jsys.DEFAULT_SYSCALLS)
    for name in (b"abort", b"sol_log_", b"sol_sha256",
                 b"sol_invoke_signed_c", b"sol_curve_group_op"):
        assert tvm.syscall_id(name) == jvm.syscall_id(name)


# name -> (source, input bytes, expected (error, r0) or None)
PROGRAMS = {
    "alu64": ("""
        mov64 r1, 7
        add64 r1, 5
        mul64 r1, 3
        mov64 r2, 5
        div64 r1, r2
        lsh64 r1, 4
        or64 r1, 1
        xor64 r1, 2
        mov64 r0, r1
        exit""", b"", ("ok", 115)),
    "alu32_truncates": ("""
        lddw r1, 0x1FFFFFFFF
        add32 r1, 1
        mov64 r0, r1
        exit""", b"", ("ok", 0)),
    "neg_arsh": ("""
        mov64 r1, 16
        neg64 r1
        arsh64 r1, 2
        arsh32 r1, 1
        mov64 r0, r1
        exit""", b"", None),
    "byteswap": ("""
        lddw r1, 0x1122334455667788
        be r1, 64
        mov64 r2, r1
        le r2, 16
        be r1, 32
        add64 r1, r2
        mov64 r0, r1
        exit""", b"", None),
    "div0": ("mov64 r1, 1; mov64 r2, 0; div64 r1, r2; exit", b"",
             ("divide_by_zero", 0)),
    "mod0": ("mov64 r1, 1; mov64 r2, 0; mod32 r1, r2; exit", b"",
             ("divide_by_zero", 0)),
    "jumps_signed_unsigned": ("""
        mov64 r1, 0
        sub64 r1, 1
        mov64 r2, 1
        mov64 r0, 0
        jgt r1, r2, +1
        exit
        add64 r0, 1
        jslt r1, r2, +1
        exit
        add64 r0, 2
        jset r1, 8, +1
        exit
        jsge r2, r1, +1
        exit
        add64 r0, 4
        exit""", b"", ("ok", 7)),
    "stack": ("""
        mov64 r1, 0x1234
        stxdw [r10-8], r1
        stb [r10-9], 7
        ldxb r2, [r10-9]
        ldxdw r0, [r10-8]
        add64 r0, r2
        exit""", b"", ("ok", 0x123B)),
    "stack_guard": ("mov64 r1, 1; stxdw [r10+16], r1; exit", b"",
                    ("access_violation", 0)),
    "input_rw": ("""
        ldxw r0, [r1+0]
        add64 r0, 1
        stxw [r1+4], r0
        ldxh r3, [r1+4]
        stxh [r1+6], r3
        exit""", (41).to_bytes(4, "little") + bytes(4), ("ok", 42)),
    "rodata_readonly": (
        "mov64 r1, 1; lddw r2, 0x100000000; stxdw [r2+0], r1; exit", b"",
        ("access_violation", 0)),
    "past_input_end": ("ldxdw r0, [r1+4096]; exit", bytes(8),
                       ("access_violation", 0)),
    "null_deref": ("mov64 r1, 0; ldxdw r0, [r1+0]; exit", bytes(8),
                   ("access_violation", 0)),
    "internal_call": ("""
        mov64 r6, 7
        mov64 r1, 5
        call_fn 5
        add64 r0, r6
        exit
        mov64 r6, 99
        stxdw [r10-8], r1
        ldxdw r0, [r10-8]
        add64 r0, 10
        exit""", b"", ("ok", 22)),
    "call_depth": ("call_fn 0; exit", b"", ("call_depth_exceeded", 0)),
    "budget": ("ja -1", b"", ("compute_budget_exceeded", 0)),
    "callx": ("""
        lddw r3, 0x100000028
        callx r3
        add64 r0, 1
        exit
        mov64 r0, 41
        exit""", b"", ("ok", 42)),
    "callx_bad_target": ("lddw r3, 0x100000004; callx r3; exit", b"",
                         ("invalid_pc", 0)),
    "jmp32_low_bits": ("""
        lddw r1, 0x100000007
        mov64 r0, 0
        jeq32 r1, 7, +1
        exit
        mov64 r0, 1
        jeq r1, 7, +2
        mov64 r2, 1
        exit
        mov64 r0, 99
        exit""", b"", ("ok", 1)),
    "jmp32_signed": ("""
        lddw r1, 0xFFFFFFFF
        mov64 r0, 0
        jslt r1, 0, +3
        jslt32 r1, 0, +1
        exit
        mov64 r0, 1
        exit
        mov64 r0, 99
        exit""", b"", ("ok", 1)),
    "run_off_the_end": ("mov64 r0, 1", b"", ("invalid_pc", 1)),
    "abort": (f"call {sid(b'abort')}; exit", b"", ("aborted", 0)),
    "unknown_syscall": ("call 0xdeadbeef; exit", b"",
                        ("unknown_syscall", 0)),
    "log_and_sha256": (f"""
        mov64 r2, 8
        call {sid(b'sol_log_')}
        lddw r1, {IN}
        stxdw [r10-32], r1
        mov64 r1, 8
        stxdw [r10-24], r1
        mov64 r1, r10
        add64 r1, -32
        mov64 r2, 1
        lddw r3, {IN + 16}
        call {sid(b'sol_sha256')}
        mov64 r1, 1
        mov64 r2, 2
        mov64 r3, 3
        mov64 r4, 4
        mov64 r5, 5
        call {sid(b'sol_log_64_')}
        mov64 r0, 0
        exit""", b"hello vm" + bytes(56), ("ok", 0)),
    "memops": (f"""
        lddw r1, {IN + 16}
        lddw r2, {IN}
        mov64 r3, 8
        call {sid(b'sol_memcpy_')}
        lddw r1, {IN + 24}
        mov64 r2, 0x5a
        mov64 r3, 8
        call {sid(b'sol_memset_')}
        lddw r1, {IN}
        lddw r2, {IN + 24}
        mov64 r3, 8
        lddw r4, {IN + 32}
        call {sid(b'sol_memcmp_')}
        ldxw r0, [r1+32]
        exit""", b"abcdefgh" + bytes(40), ("ok", (ord("a") - 0x5a))),
    "sysvars": (f"""
        lddw r1, {IN}
        call {sid(b'sol_get_clock_sysvar')}
        lddw r1, {IN + 40}
        call {sid(b'sol_get_rent_sysvar')}
        lddw r1, {IN + 64}
        call {sid(b'sol_get_epoch_schedule_sysvar')}
        ldxdw r0, [r1-64]
        exit""", bytes(128), ("ok", 12345)),
    "return_data": (f"""
        lddw r1, {IN}
        mov64 r2, 6
        call {sid(b'sol_set_return_data')}
        lddw r1, {IN + 16}
        mov64 r2, 4
        lddw r3, {IN + 32}
        call {sid(b'sol_get_return_data')}
        exit""", b"from-A" + bytes(90), ("ok", 6)),
    "return_data_too_large": (f"""
        lddw r1, {IN}
        mov64 r2, 1025
        call {sid(b'sol_set_return_data')}
        exit""", bytes(2048), ("aborted", 0)),
    "syscall_budget": (f"""
        lddw r1, {IN}
        mov64 r2, 1
        lddw r3, {IN + 16}
        call {sid(b'sol_sha256')}
        exit""", struct.pack("<QQ", IN + 64, 64 * 90) + bytes(64 * 91),
        ("compute_budget_exceeded", 0)),
}

CLOCK = struct.pack("<QqQQq", 12345, 1_700_000_000, 3, 4, 1_700_000_400)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_reference(name):
    src, inp, want = PROGRAMS[name]
    budget = 150 if name == "syscall_budget" else 1000
    err, r0, cu, log, rdata, regions, _ = run_both(
        src, input_data=inp, compute_budget=budget,
        sysvars={"clock": CLOCK})
    if want is not None:
        assert (err, r0) == want
    if name == "log_and_sha256":
        assert log[0] == "hello vm"
        assert regions[3][16:48] == hashlib.sha256(b"hello vm").digest()
    if name == "budget":
        assert cu == 1001


def test_syscall_raising_becomes_typed_fault():
    def boom(vm, *a):
        raise RuntimeError("bug in syscall")
    assert run_both("call 0x99\nexit", syscalls={0x99: boom})[0] \
        == "aborted"


def _curve_input(curve):
    if curve == 0:
        b = jed.BASEPOINT
        pts = [jed.pt_compress(jed.pt_mul(n, b)) for n in (1, 2, 3)]
    else:
        b = jrr.base()
        pts = [jrr.encode(jrr.mul(n, b)) for n in (1, 2, 3)]
    return pts


@pytest.mark.parametrize("curve,op", [(c, o) for c in (0, 1)
                                      for o in (0, 1, 2)] + [(2, 0)])
def test_curve_syscalls_match_reference(curve, op):
    """sol_curve_validate_point and sol_curve_group_op on edwards and
    ristretto (ADD, SUB, MUL) through a VM program; an unknown curve id
    returns 1. Input: B | 2B | scalar 3 | out."""
    pts = _curve_input(min(curve, 1))
    left = (3).to_bytes(32, "little") if op == 2 else pts[1]
    inp = pts[0] + left + bytes(32) + b"\xff" * 32
    src = f"""
        mov64 r1, {curve}
        lddw r2, {IN}
        call {sid(b'sol_curve_validate_point')}
        mov64 r6, r0
        mov64 r1, {curve}
        lddw r2, {IN + 96}
        call {sid(b'sol_curve_validate_point')}
        lsh64 r0, 1
        or64 r6, r0
        mov64 r1, {curve}
        mov64 r2, {op}
        lddw r3, {IN + 32}
        lddw r4, {IN}
        lddw r5, {IN + 64}
        call {sid(b'sol_curve_group_op')}
        lsh64 r0, 2
        or64 r0, r6
        exit"""
    err, r0, _, _, _, regions, _ = run_both(src, input_data=inp,
                                            compute_budget=5000)
    assert err == "ok"
    if curve == 2:
        assert r0 == 0b111
        return
    assert r0 == 0b010
    want = pts[0] if op == 1 else pts[2]      # 2B - B, 2B + B, 3 * B
    assert regions[3][64:96] == want


@pytest.mark.parametrize("op", [0, 1, 2, 3, 4])
def test_alt_bn128_syscall_matches_reference(op):
    """sol_alt_bn128_group_op: ADD, SUB, MUL of G1 points, one pairing
    check (e(2P, 3Q) e(-6P, Q) = 1), and an unknown op."""
    g1, g2 = jbn.G1_GEN, jbn.G2_GEN

    def enc_g2(pt):
        (x0, x1), (y0, y1) = pt
        return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))
    if op in (0, 1):
        data = jbn.enc_g1(jbn.g1_mul(5, g1)) + jbn.enc_g1(g1)
        out = 64
    elif op == 2:
        data = jbn.enc_g1(g1) + (7).to_bytes(32, "big")
        out = 64
    elif op == 3:
        data = (jbn.enc_g1(jbn.g1_mul(2, g1)) + enc_g2(jbn.g2_mul(3, g2))
                + jbn.enc_g1(jbn.g1_neg(jbn.g1_mul(6, g1))) + enc_g2(g2))
        out = 32
    else:
        data, out = bytes(64), 64
    src = f"""
        mov64 r1, {op}
        lddw r2, {IN}
        mov64 r3, {len(data)}
        lddw r4, {IN + len(data)}
        call {sid(b'sol_alt_bn128_group_op')}
        exit"""
    err, r0, cu, _, _, regions, _ = run_both(
        src, input_data=data + bytes(out), compute_budget=100_000)
    assert err == "ok"
    assert r0 == (1 if op == 4 else 0)
    if op == 3:
        assert regions[3][len(data):][-1] == 1


def test_tracer_and_disasm_match_reference():
    prog = tvm.asm("""
        mov64 r1, 7
        mov64 r2, 5
        add64 r1, r2
        lsh64 r1, 1
        jeq r3, 9, +4
        ldxdw r2, [r10-8]
        stxw [r10-4], r3
        stw [r10-12], 5
        be r1, 16
        neg32 r2
        exit""")
    got = []
    for vm_mod, _, tr_mod in PKGS:
        vm = vm_mod.Vm(prog)
        tr = tr_mod.Tracer(limit=3).attach(vm)
        vm.run()
        got.append((tr.count, [(e.pc, e.cu, e.regs, e.text)
                               for e in tr.entries], tr.format(2),
                    [tr_mod.disasm(prog[i:i + 8])
                     for i in range(0, len(prog), 8)]))
    assert got[1] == got[0]
    assert got[1][0] == 11 and got[1][1][-1][3] == "exit"


# -- random instruction streams -------------------------------------------

_ALU = [0x00, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60, 0x70, 0x80, 0x90,
        0xA0, 0xB0, 0xC0]
_JMP = [0x10, 0x20, 0x30, 0x40, 0x50, 0x60, 0x70, 0xA0, 0xB0, 0xC0,
        0xD0]
_LDX = [0x61, 0x69, 0x71, 0x79]
_ST = [0x62, 0x6A, 0x72, 0x7A, 0x63, 0x6B, 0x73, 0x7B]


def _insn(op, dst=0, src=0, off=0, imm=0):
    return struct.pack("<BBhi", op, (src << 4) | dst, off, imm)


@st.composite
def _streams(draw):
    n = draw(st.integers(1, 24))
    out = []
    regs = st.integers(0, 9)
    imms = st.one_of(st.integers(-8, 8), st.integers(-2**31, 2**31 - 1))
    for _ in range(n):
        kind = draw(st.integers(0, 9))
        if kind <= 3:                   # ALU64 / ALU32, imm or reg
            cls = draw(st.sampled_from([0x07, 0x04]))
            code = draw(st.sampled_from(_ALU))
            use_reg = draw(st.booleans())
            out.append(_insn(cls | code | (0x08 if use_reg else 0),
                             draw(regs), draw(regs), 0, draw(imms)))
        elif kind == 4:                 # byte swaps
            out.append(_insn(draw(st.sampled_from([0xD4, 0xDC])),
                             draw(regs), 0, 0,
                             draw(st.sampled_from([16, 32, 64]))))
        elif kind == 5:                 # conditional jumps, jmp / jmp32
            cls = draw(st.sampled_from([0x05, 0x06]))
            use_reg = draw(st.booleans())
            out.append(_insn(cls | draw(st.sampled_from(_JMP))
                             | (0x08 if use_reg else 0), draw(regs),
                             draw(regs), draw(st.integers(-3, 3)),
                             draw(imms)))
        elif kind == 6:                 # loads from the stack or input
            base = draw(st.sampled_from([1, 10]))
            out.append(_insn(draw(st.sampled_from(_LDX)), draw(regs),
                             base, draw(st.integers(-16, 64)), 0))
        elif kind == 7:                 # stores to the stack or input
            base = draw(st.sampled_from([1, 10]))
            out.append(_insn(draw(st.sampled_from(_ST)), base,
                             draw(regs), draw(st.integers(-16, 64)),
                             draw(imms)))
        elif kind == 8:                 # lddw, log_64, an internal call
            which = draw(st.integers(0, 2))
            if which == 0:
                v = draw(st.integers(0, 2**64 - 1))
                out.append(_insn(0x18, draw(regs), 0, 0,
                                 struct.unpack("<i", struct.pack(
                                     "<I", v & 0xFFFFFFFF))[0]))
                out.append(_insn(0x00, 0, 0, 0, struct.unpack(
                    "<i", struct.pack("<I", v >> 32))[0]))
            elif which == 1:
                out.append(_insn(0x85, 0, 0, 0, struct.unpack(
                    "<i", struct.pack("<I", telf.murmur3_32(
                        b"sol_log_64_")))[0]))
            else:
                out.append(_insn(0x85, 0, 1, 0,
                                 draw(st.integers(0, n))))
        else:                           # raw bytes: bad opcodes too
            out.append(draw(st.binary(min_size=8, max_size=8)))
    out.append(_insn(0x95))
    return b"".join(out)


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(prog=_streams(), inp=st.binary(min_size=64, max_size=64))
def test_random_instruction_streams_match_reference(prog, inp):
    """Random streams (ALU, swaps, jumps, loads and stores on the stack
    and input, lddw, log_64, internal calls, raw bytes) under a 300 CU
    budget: the fault, r0, the CU used, the log, the memory and the
    register file at every traced step equal."""
    run_both(prog, input_data=inp, compute_budget=300, trace=True)
