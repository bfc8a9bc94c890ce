"""VM execution tracer + disassembler (copy of the JAX package's
vm/trace.py; ref: src/flamenco/vm/
fd_vm_trace.c, fd_vm_disasm.c — per-instruction register/compute
capture for divergence hunting; paired with solcap the way the
reference pairs its tracer with the capture tooling).

The tracer attaches to a Vm as `vm.trace`; the interpreter calls
`on_instr` before executing each instruction. Entries are bounded
(ring semantics — the newest `limit` survive) so tracing a runaway
program cannot exhaust memory."""
from __future__ import annotations

from dataclasses import dataclass

_ALU_NAMES = {0x00: "add", 0x10: "sub", 0x20: "mul", 0x30: "div",
              0x40: "or", 0x50: "and", 0x60: "lsh", 0x70: "rsh",
              0x80: "neg", 0x90: "mod", 0xA0: "xor", 0xB0: "mov",
              0xC0: "arsh", 0xD0: "end"}
_JMP_NAMES = {0x00: "ja", 0x10: "jeq", 0x20: "jgt", 0x30: "jge",
              0x40: "jset", 0x50: "jne", 0x60: "jsgt", 0x70: "jsge",
              0x80: "call", 0x90: "exit", 0xA0: "jlt", 0xB0: "jle",
              0xC0: "jslt", 0xD0: "jsle"}
_SZ_NAMES = {0x00: "w", 0x08: "h", 0x10: "b", 0x18: "dw"}


def disasm(ins: bytes) -> str:
    """One 8-byte instruction -> mnemonic text (fd_vm_disasm flavor)."""
    op = ins[0]
    dst = ins[1] & 0x0F
    src = (ins[1] >> 4) & 0x0F
    off = int.from_bytes(ins[2:4], "little", signed=True)
    imm = int.from_bytes(ins[4:8], "little", signed=True)
    cls = op & 0x07
    if cls in (0x07, 0x04):                     # alu64 / alu32
        w = "64" if cls == 0x07 else "32"
        name = _ALU_NAMES.get(op & 0xF0, f"alu?{op:#x}")
        if name == "neg":
            return f"neg{w} r{dst}"
        if name == "end":
            return f"{'be' if op & 0x08 else 'le'} r{dst}, {imm}"
        rhs = f"r{src}" if op & 0x08 else str(imm)
        return f"{name}{w} r{dst}, {rhs}"
    if cls in (0x05, 0x06):                     # jmp / jmp32
        w = "" if cls == 0x05 else "32"
        name = _JMP_NAMES.get(op & 0xF0, f"jmp?{op:#x}")
        if name == "exit":
            return "exit"
        if name == "call":
            if op & 0x08:
                return f"callx r{imm}"
            return f"call {imm:#x}"
        if name == "ja":
            return f"ja {off:+d}"
        rhs = f"r{src}" if op & 0x08 else str(imm)
        return f"{name}{w} r{dst}, {rhs}, {off:+d}"
    if op == 0x18:
        return f"lddw r{dst}, {imm & 0xFFFFFFFF:#x}(lo)"
    if cls == 0x01 or cls == 0x00:              # ldx / ld
        sz = _SZ_NAMES.get(op & 0x18, "?")
        return f"ldx{sz} r{dst}, [r{src}{off:+d}]"
    if cls in (0x02, 0x03):                     # st / stx
        sz = _SZ_NAMES.get(op & 0x18, "?")
        if cls == 0x03:
            return f"stx{sz} [r{dst}{off:+d}], r{src}"
        return f"st{sz} [r{dst}{off:+d}], {imm}"
    return f"op {op:#04x}"


@dataclass
class TraceEntry:
    pc: int
    cu: int
    regs: tuple
    text: str


class Tracer:
    """Bounded per-instruction trace. attach(vm) installs it; after
    run(), `entries` holds the newest `limit` steps and `count` the
    total executed."""

    def __init__(self, limit: int = 4096):
        self.limit = limit
        self.entries: list[TraceEntry] = []
        self.count = 0

    def attach(self, vm):
        vm.trace = self
        return self

    def on_instr(self, vm, pc: int, reg: list, cu: int):
        self.count += 1
        ins = vm.text[pc * 8:pc * 8 + 8]
        self.entries.append(TraceEntry(pc, cu, tuple(reg), disasm(ins)))
        if len(self.entries) > self.limit:
            del self.entries[: len(self.entries) - self.limit]

    def format(self, last: int = 32) -> str:
        out = []
        for e in self.entries[-last:]:
            regs = " ".join(f"r{i}={v:#x}" for i, v in
                            enumerate(e.regs[:6]))
            out.append(f"{e.pc:6d} cu={e.cu:<8d} {e.text:<28s} {regs}")
        return "\n".join(out)
