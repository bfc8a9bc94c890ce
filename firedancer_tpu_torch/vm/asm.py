"""Tiny sBPF assembler (copy of the JAX package's vm/asm.py; test/tooling aid, the spirit of the reference's
fd_vm_disasm in reverse). Mnemonics follow the conventional sBPF forms:

    mov64 r1, 5        add64 r1, r2      lddw r1, 0x1122334455
    ldxdw r2, [r1+8]   stxw [r10-4], r3  stw [r1+0], 7
    jeq r1, 0, +3      jsgt r1, r2, -2   ja +1
    call 0x10          call_fn 5         callx r3      exit
    le r1, 32          be r1, 64
"""
from __future__ import annotations

import re
import struct

_ALU = {"add": 0x00, "sub": 0x10, "mul": 0x20, "div": 0x30, "or": 0x40,
        "and": 0x50, "lsh": 0x60, "rsh": 0x70, "neg": 0x80, "mod": 0x90,
        "xor": 0xA0, "mov": 0xB0, "arsh": 0xC0}
_JMP = {"jeq": 0x10, "jgt": 0x20, "jge": 0x30, "jlt": 0xA0, "jle": 0xB0,
        "jset": 0x40, "jne": 0x50, "jsgt": 0x60, "jsge": 0x70,
        "jslt": 0xC0, "jsle": 0xD0}
_SZ = {"b": 0x10, "h": 0x08, "w": 0x00, "dw": 0x18}


def _ins(op, dst=0, src=0, off=0, imm=0):
    return struct.pack("<BBhi", op, (src << 4) | dst, off,
                       imm if imm < (1 << 31) else imm - (1 << 32))


def _reg(tok):
    m = re.fullmatch(r"r(\d+)", tok)
    assert m, f"bad register {tok!r}"
    return int(m.group(1))


def _num(tok):
    return int(tok, 0)


def asm(src: str) -> bytes:
    """Assemble newline/semicolon-separated mnemonics to bytecode.
    //-comments run to end of LINE (stripped before ';' splitting, so
    semicolons inside comments are inert)."""
    out = b""
    stmts = []
    for raw_line in src.split("\n"):
        stmts.extend(raw_line.split("//")[0].split(";"))
    for raw in stmts:
        line = raw.strip().replace(",", " ")
        if not line:
            continue
        t = line.split()
        m = t[0]
        if m == "exit":
            out += _ins(0x95)
        elif m == "ja":
            out += _ins(0x05, off=_num(t[1]))
        elif m == "call":
            out += _ins(0x85, imm=_num(t[1]))
        elif m == "call_fn":      # absolute target pc (src=1 form)
            out += _ins(0x85, src=1, imm=_num(t[1]))
        elif m == "callx":
            out += _ins(0x8D, dst=_reg(t[1]))
        elif m == "lddw":
            v = _num(t[2]) & ((1 << 64) - 1)
            out += _ins(0x18, dst=_reg(t[1]), imm=v & 0xFFFFFFFF)
            out += _ins(0x00, imm=(v >> 32) & 0xFFFFFFFF)
        elif m in ("le", "be"):
            out += _ins(0xD4 if m == "le" else 0xDC, dst=_reg(t[1]),
                        imm=_num(t[2]))
        elif m[:-2] in _ALU and m.endswith("64") or \
                m[:-2] in _ALU and m.endswith("32"):
            code = _ALU[m[:-2]]
            is64 = m.endswith("64")
            base = 0x07 if is64 else 0x04
            if code == 0x80:              # neg has no operand
                out += _ins(base | code, dst=_reg(t[1]))
            elif t[2].startswith("r"):
                out += _ins(base | code | 0x08, dst=_reg(t[1]),
                            src=_reg(t[2]))
            else:
                out += _ins(base | code, dst=_reg(t[1]), imm=_num(t[2]))
        elif m.startswith("ldx"):
            sz = _SZ[m[3:]]
            mm = re.fullmatch(r"\[(r\d+)([+-]\d+)?\]", t[2])
            out += _ins(0x61 | sz, dst=_reg(t[1]), src=_reg(mm.group(1)),
                        off=int(mm.group(2) or 0))
        elif m.startswith("stx") or m.startswith("st"):
            stx = m.startswith("stx")
            sz = _SZ[m[3 if stx else 2:]]
            mm = re.fullmatch(r"\[(r\d+)([+-]\d+)?\]", t[1])
            if stx:
                out += _ins(0x63 | sz, dst=_reg(mm.group(1)),
                            src=_reg(t[2]), off=int(mm.group(2) or 0))
            else:
                out += _ins(0x62 | sz, dst=_reg(mm.group(1)),
                            off=int(mm.group(2) or 0), imm=_num(t[2]))
        elif m in _JMP or (m.endswith("32") and m[:-2] in _JMP):
            # jeq32/jsgt32/... compare the low 32 bits (class 0x06)
            cls = 0x05 if m in _JMP else 0x06
            code = _JMP[m if m in _JMP else m[:-2]]
            if t[2].startswith("r"):
                out += _ins(cls | code | 0x08, dst=_reg(t[1]),
                            src=_reg(t[2]), off=_num(t[3]))
            else:
                out += _ins(cls | code, dst=_reg(t[1]),
                            imm=_num(t[2]), off=_num(t[3]))
        else:
            raise AssertionError(f"unknown mnemonic {line!r}")
    return out
