"""sBPF ELF loader: parse + dynamic relocation of deployed programs
(copy of the JAX package's vm/elf.py).

Clean-room implementation of the reference loader's contract
(ref: src/ballet/sbpf/fd_sbpf_loader.h:1-12 — "performs no dynamic
memory allocations ... will perform dynamic relocation";
fd_sbpf_loader.c:390-395 relocation kinds, :747 e_machine gate,
murmur3-32 call-target convention via src/ballet/murmur3/):

* ELF64 little-endian, e_machine EM_BPF (247) or EM_SBPF (263).
* The whole file image maps at MM_PROGRAM_START (RODATA_START,
  0x1_0000_0000); .text executes in place at its file offset.
* Relocations applied from .rel.dyn (Elf64_Rel, implicit addends):
    R_BPF_64_64 (1)        lddw imm pair <- symbol value (+ base when
                           the value is image-relative)
    R_BPF_64_RELATIVE (8)  lddw imm pair / data u64 <- value + base
    R_BPF_64_32 (10)       call imm <- murmur3_32(target_pc) for
                           defined functions, murmur3_32(symbol name)
                           for undefined (syscalls)
* The call registry maps murmur3_32(pc) -> pc so the interpreter can
  resolve `call imm` for internal calls the way the reference VM does
  (fd_sbpf_loader.h:300-310).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

EM_BPF = 247
EM_SBPF = 263

R_BPF_64_64 = 1
R_BPF_64_RELATIVE = 8
R_BPF_64_32 = 10

MM_PROGRAM_START = 0x1_0000_0000


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """murmur3 x86 32-bit (the reference's fd_murmur3_32; used for
    syscall name hashes and call-target pc hashes)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    for i in range(0, n - n % 4, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n - n % 4:]
    if tail:
        k = int.from_bytes(tail, "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def pc_hash(pc: int) -> int:
    """Call-target hash: murmur3_32 over the u64 LE target pc
    (the reference's (murmur3_32(target_pc), target_pc) registry)."""
    return murmur3_32(pc.to_bytes(8, "little"))


class ElfError(ValueError):
    pass


@dataclass
class SbpfProgram:
    image: bytes               # full file image (maps at RODATA_START)
    text_off: int              # file offset of .text
    text_sz: int
    entry_pc: int
    calls: dict = field(default_factory=dict)   # murmur3(pc) -> pc
    syscalls_used: set = field(default_factory=set)

    @property
    def text(self) -> bytes:
        return self.image[self.text_off:self.text_off + self.text_sz]


def _shdr(img, shoff, i, shentsize):
    off = shoff + i * shentsize
    (name, sh_type, flags, addr, offset, size, link, info, align,
     entsize) = struct.unpack_from("<IIQQQQIIQQ", img, off)
    return {"name": name, "type": sh_type, "flags": flags, "addr": addr,
            "offset": offset, "size": size, "link": link, "info": info,
            "entsize": entsize}


def load(data: bytes) -> SbpfProgram:
    """Parse + relocate; every malformed-input failure surfaces as
    ElfError (hostile program bytes must fail the TRANSACTION, never
    crash the executor)."""
    try:
        return _load(data)
    except ElfError:
        raise
    except (ValueError, IndexError, struct.error) as e:
        raise ElfError(f"malformed ELF: {e}")


def _load(data: bytes) -> SbpfProgram:
    if len(data) < 64 or data[:4] != b"\x7fELF":
        raise ElfError("not an ELF")
    if data[4] != 2 or data[5] != 1:
        raise ElfError("need ELF64 little-endian")
    (e_type, e_machine, _ver, e_entry, _phoff, e_shoff, _flags, _ehsz,
     _phentsz, _phnum, e_shentsize, e_shnum, e_shstrndx) = \
        struct.unpack_from("<HHIQQQIHHHHHH", data, 16)
    if e_machine not in (EM_BPF, EM_SBPF):
        raise ElfError(f"e_machine {e_machine} is not (s)BPF")
    if e_shoff == 0 or e_shnum == 0:
        raise ElfError("no section headers")
    if e_shoff + e_shnum * e_shentsize > len(data):
        raise ElfError("section headers out of bounds")
    shdrs = [_shdr(data, e_shoff, i, e_shentsize) for i in range(e_shnum)]
    if e_shstrndx >= e_shnum:
        raise ElfError("bad shstrndx")
    strtab = shdrs[e_shstrndx]

    def sname(off):
        base = strtab["offset"] + off
        end = data.index(b"\x00", base)
        return data[base:end].decode("latin-1")

    by_name = {}
    for sh in shdrs:
        sh["sname"] = sname(sh["name"])
        by_name[sh["sname"]] = sh
    text = by_name.get(".text")
    if text is None or text["size"] == 0 or text["size"] % 8:
        raise ElfError("missing or misaligned .text")
    if text["offset"] + text["size"] > len(data):
        raise ElfError(".text out of bounds")

    img = bytearray(data)
    calls: dict[int, int] = {}
    syscalls_used: set[str] = set()

    # --- pc-relative call fixup (BEFORE relocations) ---
    # The compiler emits local calls as `call <pc-relative imm>` and
    # leaves imm = -1 where it emitted a relocation instead; the loader
    # rewrites every relative call to murmur3_32(target_pc) and
    # registers the target (ref: fd_sbpf_loader.c:1707-1758, mirroring
    # sbpf elf.rs fixup_relative_calls).
    n_instr = text["size"] // 8
    for i in range(n_instr):
        off = text["offset"] + i * 8
        if img[off] != 0x85:
            continue
        imm = int.from_bytes(img[off + 4:off + 8], "little",
                             signed=True)
        if imm == -1:
            continue                 # relocation will fill this one
        target = i + 1 + imm
        if not 0 <= target < n_instr:
            raise ElfError(f"relative call out of bounds at pc {i}")
        h = pc_hash(target)
        calls[h] = target
        struct.pack_into("<I", img, off + 4, h)

    # dynamic symbols (for 64_64 / 64_32 relocations)
    syms = []
    dynsym = by_name.get(".dynsym")
    dynstr = by_name.get(".dynstr")
    if dynsym is not None:
        if dynsym["entsize"] not in (0, 24):
            raise ElfError("bad dynsym entsize")
        cnt = dynsym["size"] // 24
        for i in range(cnt):
            st_name, st_info, st_other, st_shndx, st_value, st_size = \
                struct.unpack_from("<IBBHQQ", data, dynsym["offset"]
                                   + 24 * i)
            nm = ""
            if dynstr is not None and st_name:
                base = dynstr["offset"] + st_name
                nm = data[base:data.index(b"\x00", base)].decode(
                    "latin-1")
            syms.append({"name": nm, "shndx": st_shndx,
                         "value": st_value, "info": st_info})

    def vaddr_to_off(va):
        # our convention (and cargo-build-sbf's v0 layout): section
        # virtual addresses equal file offsets, so the image maps 1:1
        return va

    def patch_lddw(off, addr):
        if off + 16 > len(img):
            raise ElfError("relocation out of bounds")
        struct.pack_into("<I", img, off + 4, addr & 0xFFFFFFFF)
        struct.pack_into("<I", img, off + 12, (addr >> 32) & 0xFFFFFFFF)

    rel = by_name.get(".rel.dyn")
    if rel is not None:
        if rel["entsize"] not in (0, 16):
            raise ElfError("bad rel entsize")
        for i in range(rel["size"] // 16):
            r_offset, r_info = struct.unpack_from(
                "<QQ", data, rel["offset"] + 16 * i)
            r_type = r_info & 0xFFFFFFFF
            r_sym = r_info >> 32
            off = vaddr_to_off(r_offset)
            in_text = (text["offset"] <= off
                       < text["offset"] + text["size"])
            if r_type == R_BPF_64_RELATIVE:
                # (ref: fd_sbpf_r_bpf_64_relative / sbpf elf.rs
                # L1142-1247): lddw-pair form inside .text, u32-addend
                # -> u64 slot form elsewhere (.data.rel.ro etc)
                if in_text:
                    lo = struct.unpack_from("<I", img, off + 4)[0]
                    hi = struct.unpack_from("<I", img, off + 12)[0]
                    va = lo | (hi << 32)
                    if va == 0:
                        raise ElfError("zero relative address")
                    if va < MM_PROGRAM_START:
                        va += MM_PROGRAM_START
                    patch_lddw(off, va)
                else:
                    if off + 8 > len(img):
                        raise ElfError("relocation out of bounds")
                    va = struct.unpack_from("<I", img, off + 4)[0] \
                        + MM_PROGRAM_START
                    struct.pack_into("<Q", img, off, va)
            elif r_type == R_BPF_64_64:
                # lddw imm pair <- symbol value + implicit u32 addend
                # read from the low imm slot (ref: fd_sbpf_r_bpf_64_64)
                if r_sym >= len(syms):
                    raise ElfError("bad reloc symbol")
                if off + 16 > len(img):
                    raise ElfError("relocation out of bounds")
                addend = struct.unpack_from("<I", img, off + 4)[0]
                va = syms[r_sym]["value"] + addend
                if va < MM_PROGRAM_START:
                    va += MM_PROGRAM_START
                patch_lddw(off, va)
            elif r_type == R_BPF_64_32:
                # call imm <- pc hash (defined function) or murmur of
                # the symbol name (syscall) (ref: fd_sbpf_r_bpf_64_32)
                if r_sym >= len(syms):
                    raise ElfError("bad reloc symbol")
                s = syms[r_sym]
                is_func = (s["info"] & 0x0F) == 2 and s["value"] != 0
                if is_func:
                    tgt_off = s["value"] - text["addr"]
                    if tgt_off % 8 or not (
                            0 <= tgt_off < text["size"]):
                        raise ElfError("call target outside .text")
                    pc = tgt_off // 8
                    if s["name"] == "entrypoint":
                        h = murmur3_32(b"entrypoint")
                    else:
                        h = pc_hash(pc)
                    calls[h] = pc
                    imm = h
                else:                        # undefined: syscall
                    if not s["name"]:
                        raise ElfError("unnamed syscall symbol")
                    syscalls_used.add(s["name"])
                    imm = murmur3_32(s["name"].encode())
                if off + 8 > len(img):
                    raise ElfError("relocation out of bounds")
                struct.pack_into("<I", img, off + 4, imm)
            else:
                raise ElfError(f"unsupported relocation type {r_type}")

    entry_off = vaddr_to_off(e_entry)
    if entry_off % 8 or not (text["offset"] <= entry_off
                             < text["offset"] + text["size"]):
        raise ElfError("entrypoint outside .text")
    entry_pc = (entry_off - text["offset"]) // 8
    # the entrypoint is callable under the NAME hash (the reference's
    # FD_SBPF_ENTRYPOINT_HASH special case) and its pc hash
    calls.setdefault(murmur3_32(b"entrypoint"), entry_pc)
    calls.setdefault(pc_hash(entry_pc), entry_pc)
    return SbpfProgram(bytes(img), text["offset"], text["size"],
                       entry_pc, calls, syscalls_used)
