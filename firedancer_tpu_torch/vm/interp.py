"""sBPF virtual machine: interpreter, memory map, syscalls (copy of the
JAX package's vm/interp.py).

Host-side by design — SURVEY §7 hard-part 6: "sBPF execution does not
vectorize; keep the VM on host cores" (the reference's interpreter is
src/flamenco/vm/fd_vm_interp_core.c with the memory map in
fd_vm_private.h; this is a clean-room build from the sBPF instruction
set, not a translation).

ISA: 64-bit registers r0..r9 + frame pointer r10, 8-byte instructions
(lddw spans two slots): ALU64/ALU32 (imm/reg), byte-swaps, loads/
stores (b/h/w/dw), the full jump family, internal calls (pc-relative)
with shadow-frame save of r6..r9, callx, syscalls by dispatch id, exit.

Memory map (the Solana VM layout):
  0x1_0000_0000  rodata (program)
  0x2_0000_0000  stack   (fixed 4 KiB frames with guard gaps; r10 is
                          the frame pointer, advanced per call)
  0x3_0000_0000  heap
  0x4_0000_0000  input   (serialized accounts + instruction data)

Faults (OOB access, div-by-zero, bad opcode, call depth, compute
budget) abort execution with a typed error — never raw exceptions.
Compute units are charged one per instruction (the reference's base
cost) plus per-syscall costs.
"""
from __future__ import annotations

from dataclasses import dataclass

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

RODATA_START = 0x1_0000_0000
STACK_START = 0x2_0000_0000
HEAP_START = 0x3_0000_0000
INPUT_START = 0x4_0000_0000

FRAME_SZ = 4096
FRAME_GAP = 4096
MAX_CALL_DEPTH = 64

# opcode classes (low 3 bits)
CLS_LD, CLS_LDX, CLS_ST, CLS_STX = 0x00, 0x01, 0x02, 0x03
CLS_ALU, CLS_JMP, CLS_JMP32, CLS_ALU64 = 0x04, 0x05, 0x06, 0x07

ERR_NONE = "ok"
ERR_OOB = "access_violation"
ERR_DIV0 = "divide_by_zero"
ERR_BAD_OP = "invalid_instruction"
ERR_BUDGET = "compute_budget_exceeded"
ERR_DEPTH = "call_depth_exceeded"
ERR_PC = "invalid_pc"
ERR_SYSCALL = "unknown_syscall"
ERR_ABORT = "aborted"


class VmFault(Exception):
    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind


@dataclass
class Region:
    start: int
    data: bytearray
    writable: bool


@dataclass
class VmResult:
    error: str
    r0: int
    compute_used: int
    log: list


class Vm:
    def __init__(self, program: bytes, *, input_data: bytes = b"",
                 heap_sz: int = 32 * 1024, compute_budget: int = 200_000,
                 syscalls: dict | None = None, image: bytes | None = None,
                 text_off: int = 0, calls: dict | None = None):
        """program: raw sBPF text section (8-byte instruction stream).
        syscalls: {id: fn(vm, r1..r5) -> r0} (the loader resolves name
        hashes to ids; tests register directly).
        image/text_off: ELF-loaded programs map the WHOLE relocated
        file image read-only at RODATA_START with .text executing in
        place at text_off (vm/elf.py); raw-text programs leave image
        None and the text itself is the rodata region.
        calls: {murmur3_32(pc): pc} internal-call registry — `call imm`
        resolves here before the syscall table (the reference VM's
        call-target hash map, fd_sbpf_loader.h:300-310)."""
        if len(program) % 8:
            raise ValueError("program size must be a multiple of 8")
        self.text = program
        self.n_instr = len(program) // 8
        self.text_base = RODATA_START + text_off
        self.regions = [
            Region(RODATA_START,
                   bytearray(image if image is not None else program),
                   False),
            Region(STACK_START, bytearray(
                MAX_CALL_DEPTH * (FRAME_SZ + FRAME_GAP)), True),
            Region(HEAP_START, bytearray(heap_sz), True),
            Region(INPUT_START, bytearray(input_data), True),
        ]
        self.compute_budget = compute_budget
        self.syscalls = dict(syscalls or {})
        self.calls = dict(calls or {})
        self.log: list[str] = []
        self.trace = None              # vm/trace.py Tracer, optional

    # -- memory -------------------------------------------------------------

    def _region(self, vaddr: int, sz: int, write: bool) -> tuple:
        for r in self.regions:
            off = vaddr - r.start
            if 0 <= off and off + sz <= len(r.data):
                if write and not r.writable:
                    break
                if r.start == STACK_START and not self._stack_ok(off, sz):
                    break
                return r, off
        raise VmFault(ERR_OOB, f"vaddr {vaddr:#x} sz {sz} "
                               f"{'write' if write else 'read'}")

    def _stack_ok(self, off: int, sz: int) -> bool:
        """Guard gaps between frames catch runaway stack writes
        (the reference's frame-gap discipline)."""
        frame = off // (FRAME_SZ + FRAME_GAP)
        in_frame = off - frame * (FRAME_SZ + FRAME_GAP)
        return in_frame + sz <= FRAME_SZ

    def mem_read(self, vaddr: int, sz: int) -> bytes:
        r, off = self._region(vaddr, sz, write=False)
        return bytes(r.data[off:off + sz])

    def mem_write(self, vaddr: int, data: bytes):
        r, off = self._region(vaddr, len(data), write=True)
        r.data[off:off + len(data)] = data

    def read_u(self, vaddr: int, sz: int) -> int:
        return int.from_bytes(self.mem_read(vaddr, sz), "little")

    def write_u(self, vaddr: int, sz: int, v: int):
        self.mem_write(vaddr, (v & ((1 << (8 * sz)) - 1))
                       .to_bytes(sz, "little"))

    # -- execution ----------------------------------------------------------

    def charge(self, units: int):
        """Charge extra compute units (syscall costs) against the
        budget; faults when exhausted. Valid only during run()."""
        self._cu += units
        if self._cu > self.compute_budget:
            raise VmFault(ERR_BUDGET)

    def run(self, r1: int = INPUT_START, entry_pc: int = 0) -> VmResult:
        reg = [0] * 11
        reg[1] = r1
        reg[10] = STACK_START + FRAME_SZ        # frame 0 top
        pc = entry_pc
        self._cu = 0
        shadow = []                             # (r6..r9, r10, ret pc)
        err = ERR_NONE
        try:
            while True:
                if not 0 <= pc < self.n_instr:
                    raise VmFault(ERR_PC, f"pc {pc}")
                self._cu += 1
                if self._cu > self.compute_budget:
                    raise VmFault(ERR_BUDGET)
                if self.trace is not None:
                    self.trace.on_instr(self, pc, reg, self._cu)
                i = pc * 8
                op = self.text[i]
                dst = self.text[i + 1] & 0x0F
                src = (self.text[i + 1] >> 4) & 0x0F
                offs = int.from_bytes(self.text[i + 2:i + 4], "little",
                                      signed=True)
                imm = int.from_bytes(self.text[i + 4:i + 8], "little",
                                     signed=True)
                cls = op & 0x07
                pc += 1

                if cls in (CLS_ALU64, CLS_ALU):
                    is64 = cls == CLS_ALU64
                    code = op & 0xF0
                    use_reg = bool(op & 0x08)
                    if cls == CLS_ALU and code == 0xD0:
                        # endianness ops: the 0x08 bit selects le/be,
                        # NOT the register form; result is full-width
                        width = imm // 8
                        raw = (reg[dst] & MASK64).to_bytes(8, "little")
                        if op == 0xD4:    # to-le: truncate
                            reg[dst] = int.from_bytes(raw[:width],
                                                      "little")
                        elif op == 0xDC:  # to-be: byteswap
                            reg[dst] = int.from_bytes(raw[:width], "big")
                        else:
                            raise VmFault(ERR_BAD_OP, f"op {op:#x}")
                        continue
                    a = reg[dst] if is64 else reg[dst] & MASK32
                    b = (reg[src] if use_reg else imm & MASK64)
                    if not is64:
                        b &= MASK32
                    if code == 0x00:      # add
                        a = a + b
                    elif code == 0x10:    # sub
                        a = a - b
                    elif code == 0x20:    # mul
                        a = a * b
                    elif code == 0x30:    # div (unsigned; /0 faults)
                        if b == 0:
                            raise VmFault(ERR_DIV0)
                        a = (a & (MASK64 if is64 else MASK32)) // b
                    elif code == 0x40:    # or
                        a = a | b
                    elif code == 0x50:    # and
                        a = a & b
                    elif code == 0x60:    # lsh
                        a = a << (b & (63 if is64 else 31))
                    elif code == 0x70:    # rsh (logical)
                        a = (a & (MASK64 if is64 else MASK32)) >> \
                            (b & (63 if is64 else 31))
                    elif code == 0x80:    # neg
                        a = -a
                    elif code == 0x90:    # mod
                        if b == 0:
                            raise VmFault(ERR_DIV0)
                        a = (a & (MASK64 if is64 else MASK32)) % b
                    elif code == 0xA0:    # xor
                        a = a ^ b
                    elif code == 0xB0:    # mov
                        a = b
                    elif code == 0xC0:    # arsh (arithmetic shift)
                        width = 64 if is64 else 32
                        av = a & ((1 << width) - 1)
                        if av >> (width - 1):
                            av -= 1 << width
                        a = av >> (b & (width - 1))
                    else:
                        raise VmFault(ERR_BAD_OP, f"op {op:#x}")
                    reg[dst] = (a & MASK64) if is64 else (a & MASK32)

                elif cls in (CLS_JMP, CLS_JMP32):
                    code = op & 0xF0
                    use_reg = bool(op & 0x08)
                    if op == 0x05:        # ja
                        pc += offs
                        continue
                    if op == 0x85:        # call
                        # resolution order = the reference's legacy
                        # path (fd_vm_interp_core.c 0x85depr): syscall
                        # registry first, then the hashed call registry
                        # (loader-filled), then — for hand-assembled
                        # raw-text programs only — src=1 with an
                        # in-bounds imm as a direct absolute target pc
                        fn = self.syscalls.get(imm & MASK32)
                        tgt = None
                        if fn is None:
                            tgt = self.calls.get(imm & MASK32)
                            if tgt is None and src == 1 \
                                    and 0 <= imm < self.n_instr:
                                tgt = imm
                            if tgt is None:
                                raise VmFault(ERR_SYSCALL, f"{imm:#x}")
                        if tgt is not None:
                            if len(shadow) >= MAX_CALL_DEPTH - 1:
                                raise VmFault(ERR_DEPTH)
                            shadow.append((reg[6], reg[7], reg[8],
                                           reg[9], reg[10], pc))
                            reg[10] += FRAME_SZ + FRAME_GAP
                            pc = tgt
                            continue
                        try:
                            reg[0] = fn(self, reg[1], reg[2], reg[3],
                                        reg[4], reg[5]) & MASK64
                        except VmFault:
                            raise
                        except Exception as e:
                            # a buggy syscall must surface as a typed
                            # fault, never escape run() as a raw
                            # exception
                            raise VmFault(ERR_ABORT,
                                          f"syscall raised: {e!r}")
                        continue
                    if op == 0x8D:        # callx
                        if len(shadow) >= MAX_CALL_DEPTH - 1:
                            raise VmFault(ERR_DEPTH)
                        target = reg[imm & 0x0F] if imm else reg[dst]
                        if target % 8 or not (
                                0 <= (target - self.text_base) // 8
                                < self.n_instr):
                            raise VmFault(ERR_PC, f"callx {target:#x}")
                        shadow.append((reg[6], reg[7], reg[8],
                                       reg[9], reg[10], pc))
                        reg[10] += FRAME_SZ + FRAME_GAP
                        pc = (target - self.text_base) // 8
                        continue
                    if op == 0x95:        # exit / return
                        if not shadow:
                            break
                        (reg[6], reg[7], reg[8], reg[9], reg[10],
                         pc) = shadow.pop()
                        continue
                    # jmp32 (class 0x06) compares on the low 32 bits,
                    # jmp (0x05) on the full 64 — same code points
                    width = 64 if cls == CLS_JMP else 32
                    wmask = MASK64 if cls == CLS_JMP else MASK32
                    a = reg[dst] & wmask
                    b = (reg[src] if use_reg else imm) & wmask
                    # one comparison per branch (interpreter hot loop);
                    # signed conversions only for the signed family
                    if code == 0x10:
                        take = a == b
                    elif code == 0x20:
                        take = a > b
                    elif code == 0x30:
                        take = a >= b
                    elif code == 0xA0:
                        take = a < b
                    elif code == 0xB0:
                        take = a <= b
                    elif code == 0x40:
                        take = bool(a & b)
                    elif code == 0x50:
                        take = a != b
                    elif code in (0x60, 0x70, 0xC0, 0xD0):
                        sa = a - (1 << width) if a >> (width - 1) else a
                        sb = b - (1 << width) if b >> (width - 1) else b
                        take = (sa > sb if code == 0x60 else
                                sa >= sb if code == 0x70 else
                                sa < sb if code == 0xC0 else sa <= sb)
                    else:
                        raise VmFault(ERR_BAD_OP, f"op {op:#x}")
                    if take:
                        pc += offs

                elif cls == CLS_LD:
                    if op == 0x18:        # lddw (2 slots)
                        if pc >= self.n_instr:
                            raise VmFault(ERR_PC, "truncated lddw")
                        hi = int.from_bytes(
                            self.text[pc * 8 + 4:pc * 8 + 8], "little")
                        reg[dst] = ((imm & MASK32) | (hi << 32)) & MASK64
                        pc += 1
                    else:
                        raise VmFault(ERR_BAD_OP, f"op {op:#x}")

                elif cls == CLS_LDX:
                    sz = {0x61: 4, 0x69: 2, 0x71: 1, 0x79: 8}.get(op)
                    if sz is None:
                        raise VmFault(ERR_BAD_OP, f"op {op:#x}")
                    reg[dst] = self.read_u((reg[src] + offs) & MASK64, sz)

                elif cls in (CLS_ST, CLS_STX):
                    sz = {0x62: 4, 0x6A: 2, 0x72: 1, 0x7A: 8,
                          0x63: 4, 0x6B: 2, 0x73: 1, 0x7B: 8}.get(op)
                    if sz is None:
                        raise VmFault(ERR_BAD_OP, f"op {op:#x}")
                    v = (imm & MASK64) if cls == CLS_ST else reg[src]
                    self.write_u((reg[dst] + offs) & MASK64, sz, v)

                else:
                    raise VmFault(ERR_BAD_OP, f"op {op:#x}")
        except VmFault as f:
            err = f.kind
        self.compute_used = self._cu
        return VmResult(err, reg[0], self._cu, self.log)
