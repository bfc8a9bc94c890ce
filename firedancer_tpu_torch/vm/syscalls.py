"""VM syscalls (copy of the JAX package's vm/syscalls.py; ref: src/flamenco/vm/syscall/ — log, memops, hashing;
dispatch ids are murmur3-32 of the symbol name in the reference's
loader; the ids here are the same registry concept with the hash
computed by `syscall_id`)."""
from __future__ import annotations

import hashlib

from .interp import ERR_ABORT, MASK64, VmFault

CU_SYSCALL_BASE = 100
CU_MEM_PER_250B = 1        # memop cost per 250 bytes (reference rate)
CU_SHA256_BASE = 85
CU_SHA256_PER_64B = 1


def syscall_id(name: bytes) -> int:
    """Stable 32-bit id for a syscall symbol: murmur3_32 of the name —
    the SAME hash the ELF loader stamps into relocated `call` imms
    (vm/elf.py, matching the reference's murmur3 convention), so a
    loaded program's syscalls hit this registry directly."""
    from .elf import murmur3_32
    return murmur3_32(name)


def sys_abort(vm, r1, r2, r3, r4, r5):
    raise VmFault(ERR_ABORT, "abort() called")


def sys_log(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE + r2 // 250)
    msg = vm.mem_read(r1, min(r2, 10_000))
    vm.log.append(msg.decode("utf-8", "replace"))
    return 0


def sys_log_64(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE)
    vm.log.append(" ".join(f"{x & MASK64:#x}" for x in
                           (r1, r2, r3, r4, r5)))
    return 0


def sys_memcpy(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE + r3 // 250)
    vm.mem_write(r1, vm.mem_read(r2, r3))
    return 0


def sys_memset(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE + r3 // 250)
    vm.mem_write(r1, bytes([r2 & 0xFF]) * r3)
    return 0


def sys_memcmp(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE + r3 // 250)
    a = vm.mem_read(r1, r3)
    b = vm.mem_read(r2, r3)
    res = 0
    for x, y in zip(a, b):
        if x != y:
            res = (x - y) & MASK64
            break
    vm.write_u(r4, 4, res & 0xFFFFFFFF)
    return 0


def sys_sha256(vm, r1, r2, r3, r4, r5):
    """r1: vec of (vaddr u64, len u64) slices, r2: count, r3: out."""
    vm.charge(CU_SHA256_BASE)
    h = hashlib.sha256()
    for i in range(r2):
        va = vm.read_u(r1 + 16 * i, 8)
        ln = vm.read_u(r1 + 16 * i + 8, 8)
        # charge BEFORE hashing: budget bounds work, not vice versa
        vm.charge(ln // 64 * CU_SHA256_PER_64B)
        h.update(vm.mem_read(va, ln))
    vm.mem_write(r3, h.digest())
    return 0


def sys_get_clock_sysvar(vm, r1, r2, r3, r4, r5):
    """Write the 40-byte Clock sysvar (slot, epoch_start_timestamp,
    epoch, leader_schedule_epoch, unix_timestamp — the Solana layout)
    to r1 (ref: fd_vm_syscall_runtime.c sol_get_clock_sysvar,
    fd_sysvar_clock.h). The executor injects vm.sysvars."""
    vm.charge(CU_SYSCALL_BASE)
    clock = getattr(vm, "sysvars", {}).get("clock", bytes(40))
    vm.mem_write(r1, clock)
    return 0


def sys_get_rent_sysvar(vm, r1, r2, r3, r4, r5):
    """17-byte Rent sysvar (lamports_per_byte_year u64, exemption
    threshold f64, burn_percent u8)."""
    vm.charge(CU_SYSCALL_BASE)
    rent = getattr(vm, "sysvars", {}).get(
        "rent", struct_pack_rent(3480, 2.0, 50))
    vm.mem_write(r1, rent)
    return 0


def struct_pack_rent(lamports_per_byte_year: int, threshold: float,
                     burn_percent: int) -> bytes:
    import struct
    return struct.pack("<Qd", lamports_per_byte_year, threshold) \
        + bytes([burn_percent])


def sys_get_epoch_schedule_sysvar(vm, r1, r2, r3, r4, r5):
    """33-byte EpochSchedule (slots_per_epoch u64, leader_schedule_
    slot_offset u64, warmup u8, first_normal_epoch u64,
    first_normal_slot u64) — served from the same cache the account
    view feeds (svm/sysvars.py)."""
    vm.charge(CU_SYSCALL_BASE)
    es = getattr(vm, "sysvars", {}).get("epoch_schedule")
    if es is None:
        import struct
        es = struct.pack("<QQBQQ", 432_000, 432_000, 0, 0, 0)
    vm.mem_write(r1, es)
    return 0


RETURN_DATA_MAX = 1024


def sys_set_return_data(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE + r2 // 250)
    if r2 > RETURN_DATA_MAX:
        raise VmFault(ERR_ABORT, "return data too large")
    vm.return_data = vm.mem_read(r1, r2) if r2 else b""
    vm.return_data_program = getattr(vm, "program_id", bytes(32))
    return 0


def sys_get_return_data(vm, r1, r2, r3, r4, r5):
    vm.charge(CU_SYSCALL_BASE)
    data = getattr(vm, "return_data", b"")
    n = min(len(data), r2)
    if n:
        vm.mem_write(r1, data[:n])
        vm.mem_write(r3, getattr(vm, "return_data_program",
                                 bytes(32)))
    return len(data)


CURVE_EDWARDS = 0
CURVE_RISTRETTO = 1
CURVE_OP_ADD = 0
CURVE_OP_SUB = 1
CURVE_OP_MUL = 2
CU_CURVE_VALIDATE = 159        # Agave's curve25519 cost constants
CU_CURVE_OP = 473


def sys_curve_validate_point(vm, r1, r2, r3, r4, r5):
    """sol_curve_validate_point(curve_id, point_addr) -> 0 valid /
    1 invalid (ref: src/flamenco/vm/syscall/fd_vm_syscall_curve.c)."""
    vm.charge(CU_CURVE_VALIDATE)
    pt = vm.mem_read(r2, 32)
    if r1 == CURVE_EDWARDS:
        from ..utils.ed25519_ref import pt_decompress
        return 0 if pt_decompress(pt) is not None else 1
    if r1 == CURVE_RISTRETTO:
        from ..utils.ristretto import validate
        return 0 if validate(pt) else 1
    return 1


def sys_curve_group_op(vm, r1, r2, r3, r4, r5):
    """sol_curve_group_op(curve_id, op, left_addr, right_addr,
    result_addr): ADD/SUB point⊕point, MUL scalar·point; writes 32
    bytes on success, returns 0/1 (the Agave ABI)."""
    vm.charge(CU_CURVE_OP)
    left = vm.mem_read(r3, 32)
    right = vm.mem_read(r4, 32)
    if r1 == CURVE_EDWARDS:
        from ..utils.ed25519_ref import (L, pt_add, pt_compress,
                                         pt_decompress, pt_mul)

        def dec(b):
            return pt_decompress(b)

        def enc(p):
            return pt_compress(p)

        def neg(p):
            x, y, z, t = p
            from ..utils.ed25519_ref import P as _P
            return ((-x) % _P, y, z, (-t) % _P)
        add_, mul_ = pt_add, pt_mul
    elif r1 == CURVE_RISTRETTO:
        from ..utils.ed25519_ref import L
        from ..utils import ristretto as rr

        def dec(b):
            return rr.decode(b)

        def enc(p):
            return rr.encode(p)

        def neg(p):
            x, y, z, t = p
            return ((-x) % rr.P, y, z, (-t) % rr.P)
        add_, mul_ = rr.add, rr.mul
    else:
        return 1
    if r2 in (CURVE_OP_ADD, CURVE_OP_SUB):
        a = dec(left)
        b = dec(right)
        if a is None or b is None:
            return 1
        if r2 == CURVE_OP_SUB:
            b = neg(b)
        vm.mem_write(r5, enc(add_(a, b)))
        return 0
    if r2 == CURVE_OP_MUL:
        scalar = int.from_bytes(left, "little")
        if scalar >= L:
            return 1               # non-canonical scalar rejected
        p = dec(right)
        if p is None:
            return 1
        vm.mem_write(r5, enc(mul_(scalar, p)))
        return 0
    return 1


ALT_BN128_ADD = 0
ALT_BN128_SUB = 1
ALT_BN128_MUL = 2
ALT_BN128_PAIRING = 3
CU_BN128_ADD = 334
CU_BN128_MUL = 3840
CU_BN128_PAIRING_FIRST = 36364
CU_BN128_PAIRING_OTHER = 12121


def sys_alt_bn128_group_op(vm, r1, r2, r3, r4, r5):
    """sol_alt_bn128_group_op(op, input_addr, input_len, result_addr)
    — EIP-196/197 semantics (ref: src/flamenco/vm/syscall wiring of
    src/ballet/bn254/). Returns 0 and writes the result on success,
    1 on malformed/off-curve input (matching Agave's error-to-r0)."""
    from ..utils import bn254 as bn
    data = vm.mem_read(r2, r3) if r3 else b""
    try:
        if r1 == ALT_BN128_ADD:
            vm.charge(CU_BN128_ADD)
            out = bn.alt_bn128_add(data)
        elif r1 == ALT_BN128_SUB:
            vm.charge(CU_BN128_ADD)
            out = bn.alt_bn128_sub(data)
        elif r1 == ALT_BN128_MUL:
            vm.charge(CU_BN128_MUL)
            out = bn.alt_bn128_mul(data)
        elif r1 == ALT_BN128_PAIRING:
            # first + other*(n-1), nothing for empty input (the
            # reference's pairing cost shape)
            n = r3 // 192
            if n:
                vm.charge(CU_BN128_PAIRING_FIRST
                          + CU_BN128_PAIRING_OTHER * (n - 1))
            out = bn.alt_bn128_pairing(data)
        else:
            return 1
    except ValueError:
        return 1
    vm.mem_write(r4, out)
    return 0


DEFAULT_SYSCALLS = {
    syscall_id(b"abort"): sys_abort,
    syscall_id(b"sol_log_"): sys_log,
    syscall_id(b"sol_log_64_"): sys_log_64,
    syscall_id(b"sol_memcpy_"): sys_memcpy,
    syscall_id(b"sol_memset_"): sys_memset,
    syscall_id(b"sol_memcmp_"): sys_memcmp,
    syscall_id(b"sol_sha256"): sys_sha256,
    syscall_id(b"sol_get_clock_sysvar"): sys_get_clock_sysvar,
    syscall_id(b"sol_get_rent_sysvar"): sys_get_rent_sysvar,
    syscall_id(b"sol_get_epoch_schedule_sysvar"):
        sys_get_epoch_schedule_sysvar,
    syscall_id(b"sol_set_return_data"): sys_set_return_data,
    syscall_id(b"sol_get_return_data"): sys_get_return_data,
    syscall_id(b"sol_curve_validate_point"): sys_curve_validate_point,
    syscall_id(b"sol_curve_group_op"): sys_curve_group_op,
    syscall_id(b"sol_alt_bn128_group_op"): sys_alt_bn128_group_op,
}
