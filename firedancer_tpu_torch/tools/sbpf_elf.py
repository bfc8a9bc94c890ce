"""A small sBPF ELF64 writer: assembles a program written with labels
and writes a valid sBPF ELF image instruction by instruction, the way
tests/test_elf_cpi.py's `_build_elf` writes the reference's fixture (no
Solana toolchain is needed or fetched). The image is what vm/elf.py
loads as a cargo-build-sbf artifact would be loaded: an ELF header,
.text, .rodata, .dynstr, .dynsym, .rel.dyn and .shstrtab, section
addresses equal to file offsets, e_machine EM_SBPF.

The source is vm/asm.py's mnemonics, plus:

    name:                a label (an instruction's pc)
    jeq r1, 0, name      a jump (any of the jump family, or ja) to a label
    call name            a label: an internal call, through an
                         R_BPF_64_32 relocation to a defined function
                         symbol (the loader registers its pc hash)
    call sol_log_        anything else: a syscall, through an
                         R_BPF_64_32 relocation to an undefined symbol
                         (the loader stamps murmur3 of the name)
    lddw r1, @off        the address of .rodata + off, through an
                         R_BPF_64_RELATIVE relocation

`build(src, rodata)` -> the image; `entrypoint:` (or pc 0) is e_entry.
"""
from __future__ import annotations

import re
import struct

from ..vm.asm import asm
from ..vm.elf import EM_SBPF, R_BPF_64_32, R_BPF_64_RELATIVE

_JUMPS = {"ja", "jeq", "jgt", "jge", "jlt", "jle", "jset", "jne", "jsgt",
          "jsge", "jslt", "jsle"}
_LABEL = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):$")


def _statements(src: str) -> list[str]:
    out = []
    for line in src.split("\n"):
        for stmt in line.split("//")[0].split(";"):
            stmt = stmt.strip()
            if stmt:
                out.append(stmt)
    return out


def assemble(src: str) -> tuple[bytes, dict, list, list]:
    """-> (text, labels {name: pc}, rodata relocations [pc], call
    relocations [(pc, symbol name, is_label)])."""
    labels, pcs, pc = {}, [], 0
    for s in _statements(src):
        m = _LABEL.match(s)
        if m:
            labels[m.group(1)] = pc
            continue
        pcs.append((pc, s))
        pc += 2 if s.split()[0] == "lddw" else 1
    text, rodata_rel, call_rel = b"", [], []
    for pc, s in pcs:
        t = s.replace(",", " ").split()
        op = t[0]
        if op == "call" and not re.fullmatch(r"-?(0x)?[0-9a-fA-F]+", t[1]):
            call_rel.append((pc, t[1], t[1] in labels))
            s = "call -1"
        elif op == "lddw" and t[2].startswith("@"):
            rodata_rel.append((pc, int(t[2][1:], 0)))
            s = f"lddw {t[1]}, 0"
        elif (op in _JUMPS or op.endswith("32") and op[:-2] in _JUMPS) \
                and t[-1] in labels:
            t[-1] = f"{labels[t[-1]] - (pc + 1):+d}"
            s = t[0] + " " + ", ".join(t[1:])
        text += asm(s)
    return text, labels, rodata_rel, call_rel


def build(src: str, rodata: bytes = b"") -> bytes:
    """The sBPF ELF64 image of `src` with `rodata` (see the module's
    docstring for the source's forms)."""
    text, labels, rodata_rel, call_rel = assemble(src)
    ehdr_sz = 64
    text_off = ehdr_sz
    rodata_off = text_off + len(text)
    text = bytearray(text)
    for pc, off in rodata_rel:
        # the pre-relocation imm pair holds the file offset; the loader
        # adds the program region's base (R_BPF_64_RELATIVE)
        struct.pack_into("<I", text, pc * 8 + 4, rodata_off + off)
        struct.pack_into("<I", text, pc * 8 + 12, 0)
    # .dynstr / .dynsym: symbol 0 is null, then one symbol a name
    names = sorted({name for _, name, _ in call_rel})
    dynstr = b"\x00"
    name_off = {}
    for n in names:
        name_off[n] = len(dynstr)
        dynstr += n.encode() + b"\x00"
    dynstr_off = rodata_off + len(rodata)
    dynsym_off = (dynstr_off + len(dynstr) + 7) & ~7
    dynsym = struct.pack("<IBBHQQ", 0, 0, 0, 0, 0, 0)
    sym_idx = {}
    for i, n in enumerate(names, 1):
        sym_idx[n] = i
        if n in labels:             # GLOBAL FUNC in .text (section 1)
            dynsym += struct.pack("<IBBHQQ", name_off[n], 0x12, 0, 1,
                                  text_off + 8 * labels[n], 8)
        else:                       # GLOBAL NOTYPE, undefined: a syscall
            dynsym += struct.pack("<IBBHQQ", name_off[n], 0x10, 0, 0, 0,
                                  0)
    rel_off = dynsym_off + len(dynsym)
    rel = b""
    for pc, _ in rodata_rel:
        rel += struct.pack("<QQ", text_off + 8 * pc, R_BPF_64_RELATIVE)
    for pc, name, _ in call_rel:
        rel += struct.pack("<QQ", text_off + 8 * pc,
                           (sym_idx[name] << 32) | R_BPF_64_32)
    shstr = (b"\x00.text\x00.rodata\x00.dynstr\x00.dynsym\x00"
             b".rel.dyn\x00.shstrtab\x00")
    shstr_off = rel_off + len(rel)
    shoff = (shstr_off + len(shstr) + 7) & ~7

    def shdr(name, typ, off, size, link=0, entsize=0):
        return struct.pack("<IIQQQQIIQQ", name, typ, 0, off, off, size,
                           link, 0, 8, entsize)

    shdrs = shdr(0, 0, 0, 0)
    shdrs += shdr(1, 1, text_off, len(text))
    shdrs += shdr(7, 1, rodata_off, len(rodata))
    shdrs += shdr(15, 3, dynstr_off, len(dynstr))
    shdrs += shdr(23, 11, dynsym_off, len(dynsym), link=3, entsize=24)
    shdrs += shdr(31, 9, rel_off, len(rel), link=4, entsize=16)
    shdrs += shdr(40, 3, shstr_off, len(shstr))
    entry = text_off + 8 * labels.get("entrypoint", 0)
    ehdr = (b"\x7fELF" + bytes([2, 1, 1]) + bytes(9)
            + struct.pack("<HHIQQQIHHHHHH", 3, EM_SBPF, 1, entry, 0, shoff,
                          0, ehdr_sz, 0, 0, 64, 7, 6))
    img = bytearray(ehdr) + text + rodata + dynstr
    img += bytes(dynsym_off - len(img))
    img += dynsym + rel + shstr
    img += bytes(shoff - len(img))
    img += shdrs
    return bytes(img)
