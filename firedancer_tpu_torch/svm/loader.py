"""BPF upgradeable loader: the program deploy path (copy of the JAX
package's svm/loader.py).

Subset of the reference's loader-v3 program
(ref: src/flamenco/runtime/program/fd_bpf_loader_program.c —
InitializeBuffer/Write/Deploy/Upgrade/SetAuthority/Close with the
UpgradeableLoaderState account indirection): a BUFFER account collects
the ELF via Write instructions, Deploy moves it into a PROGRAMDATA
account and marks the PROGRAM account executable; execution then
dereferences program -> programdata (svm/programs.py dispatch).

State layouts (bincode enum, Agave's):
  Buffer      u32 1 | Option<authority Pubkey>
  Program     u32 2 | programdata_address 32
  ProgramData u32 3 | slot u64 | Option<upgrade_authority Pubkey>
ProgramData's ELF starts at byte 45 (4 + 8 + 1 + 32)."""
from __future__ import annotations

import struct

from ..pack.cost import BPF_UPGRADEABLE_LOADER_ID

BUFFER_META_SZ = 37           # 4 disc + 1 opt + 32 authority
PROGRAMDATA_META_SZ = 45      # 4 disc + 8 slot + 1 opt + 32 authority

IX_INIT_BUFFER = 0
IX_WRITE = 1
IX_DEPLOY = 2
IX_UPGRADE = 3
IX_SET_AUTHORITY = 4
IX_CLOSE = 5

ST_UNINIT, ST_BUFFER, ST_PROGRAM, ST_PROGRAMDATA = 0, 1, 2, 3


def buffer_state(authority: bytes | None) -> bytes:
    return struct.pack("<I", ST_BUFFER) + (
        b"\x01" + authority if authority else b"\x00" + bytes(32))


def program_state(programdata: bytes) -> bytes:
    return struct.pack("<I", ST_PROGRAM) + programdata


def programdata_state(slot: int, authority: bytes | None) -> bytes:
    return struct.pack("<IQ", ST_PROGRAMDATA, slot) + (
        b"\x01" + authority if authority else b"\x00" + bytes(32))


def parse_state(data: bytes) -> tuple[int, dict]:
    if len(data) < 4:
        raise ValueError("short loader state")
    disc, = struct.unpack_from("<I", data, 0)
    if disc == ST_BUFFER:
        if len(data) < BUFFER_META_SZ:
            raise ValueError("short buffer state")
        auth = data[5:37] if data[4] else None
        return disc, {"authority": auth, "elf": data[BUFFER_META_SZ:]}
    if disc == ST_PROGRAM:
        if len(data) < 36:
            raise ValueError("short program state")
        return disc, {"programdata": data[4:36]}
    if disc == ST_PROGRAMDATA:
        if len(data) < PROGRAMDATA_META_SZ:
            raise ValueError("short programdata state")
        slot, = struct.unpack_from("<Q", data, 4)
        auth = data[13:45] if data[12] else None
        return disc, {"slot": slot, "authority": auth,
                      "elf": data[PROGRAMDATA_META_SZ:]}
    return disc, {}


def ix_init_buffer() -> bytes:
    return struct.pack("<I", IX_INIT_BUFFER)


def ix_write(offset: int, chunk: bytes) -> bytes:
    return struct.pack("<II", IX_WRITE, offset) \
        + struct.pack("<Q", len(chunk)) + chunk


def ix_deploy(max_data_len: int) -> bytes:
    return struct.pack("<IQ", IX_DEPLOY, max_data_len)


def ix_upgrade() -> bytes:
    return struct.pack("<I", IX_UPGRADE)


def exec_upgradeable_loader(ic) -> str:
    """Accounts per instruction:
      InitializeBuffer [buffer, authority]
      Write            [buffer, authority(signer)]
      Deploy           [program, programdata, buffer, authority(signer)]
      Upgrade          [programdata, program, buffer, authority(signer)]
    """
    from .programs import (
        ERR_BAD_IX_DATA, ERR_INVALID_OWNER, ERR_MISSING_SIG,
        ERR_NOT_WRITABLE, ERR_UNKNOWN_IX, OK,
    )
    data = ic.data
    if len(data) < 4 or ic.n < 2:
        return ERR_BAD_IX_DATA
    disc, = struct.unpack_from("<I", data, 0)

    if disc == IX_INIT_BUFFER:
        buf = ic.account(0)
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if buf.owner != BPF_UPGRADEABLE_LOADER_ID or (
                buf.data and any(buf.data[:4])):
            return ERR_INVALID_OWNER
        buf.data = buffer_state(ic.key(1))
        return OK

    if disc == IX_WRITE:
        if len(data) < 16:
            return ERR_BAD_IX_DATA
        offset, = struct.unpack_from("<I", data, 4)
        ln, = struct.unpack_from("<Q", data, 8)
        chunk = data[16:16 + ln]
        if len(chunk) != ln:
            return ERR_BAD_IX_DATA
        from .programs import MAX_PERMITTED_DATA_LENGTH
        if offset + ln > MAX_PERMITTED_DATA_LENGTH:
            # a u32 offset must not drive a multi-GiB allocation
            return ERR_BAD_IX_DATA
        buf = ic.account(0)
        if buf.owner != BPF_UPGRADEABLE_LOADER_ID:
            return ERR_INVALID_OWNER
        st, info = parse_state(buf.data)
        if st != ST_BUFFER or info["authority"] is None:
            return ERR_INVALID_OWNER
        if info["authority"] != ic.key(1) or not ic.is_signer(1):
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        body = bytearray(buf.data)
        end = BUFFER_META_SZ + offset + ln
        if end > len(body):
            body += bytes(end - len(body))
        body[BUFFER_META_SZ + offset:end] = chunk
        buf.data = bytes(body)
        return OK

    if disc in (IX_DEPLOY, IX_UPGRADE):
        if ic.n < 4:
            return ERR_BAD_IX_DATA
        if disc == IX_DEPLOY:
            prog_i, pdata_i, buf_i, auth_i = 0, 1, 2, 3
        else:
            pdata_i, prog_i, buf_i, auth_i = 0, 1, 2, 3
        prog = ic.account(prog_i)
        pdata = ic.account(pdata_i)
        buf = ic.account(buf_i)
        if not ic.is_signer(auth_i):
            return ERR_MISSING_SIG
        if not (ic.is_writable(prog_i) and ic.is_writable(pdata_i)
                and ic.is_writable(buf_i)):
            return ERR_NOT_WRITABLE
        if buf.owner != BPF_UPGRADEABLE_LOADER_ID:
            return ERR_INVALID_OWNER
        bst, binfo = parse_state(buf.data)
        if bst != ST_BUFFER or binfo["authority"] != ic.key(auth_i):
            return ERR_INVALID_OWNER
        elf = binfo["elf"]
        if not elf:
            return ERR_BAD_IX_DATA
        if disc == IX_DEPLOY:
            if len(data) < 12:
                return ERR_BAD_IX_DATA
            max_data_len, = struct.unpack_from("<Q", data, 4)
            if prog.owner != BPF_UPGRADEABLE_LOADER_ID \
                    or pdata.owner != BPF_UPGRADEABLE_LOADER_ID:
                return ERR_INVALID_OWNER
            if prog.data and any(prog.data[:4]):
                return ERR_INVALID_OWNER      # already deployed
            # programdata must be UNINITIALIZED: deploying into a live
            # programdata would hijack whatever program dereferences it
            if pdata.data and any(pdata.data[:4]):
                return ERR_INVALID_OWNER
            if len(elf) > max_data_len \
                    or max_data_len > 10 * 1024 * 1024:
                return ERR_BAD_IX_DATA
        else:
            # upgrade: the PROGRAM must be loader-owned, its Program
            # state must point at THIS programdata (no repointing an
            # arbitrary writable account), and the programdata's
            # upgrade authority must be the signer
            if prog.owner != BPF_UPGRADEABLE_LOADER_ID:
                return ERR_INVALID_OWNER
            try:
                prst, prinfo = parse_state(prog.data)
            except ValueError:
                return ERR_INVALID_OWNER
            if prst != ST_PROGRAM \
                    or prinfo["programdata"] != ic.key(pdata_i):
                return ERR_INVALID_OWNER
            pst, pinfo = parse_state(pdata.data)
            if pst != ST_PROGRAMDATA \
                    or pinfo["authority"] != ic.key(auth_i):
                return ERR_INVALID_OWNER
            # the new ELF must fit the deploy-time allocation
            if len(elf) > len(pdata.data) - PROGRAMDATA_META_SZ:
                return ERR_BAD_IX_DATA
        # pre-validate the ELF so a broken deploy fails the TXN, not
        # later executions (the reference verifies at deploy too)
        from ..vm import elf as elf_mod
        try:
            elf_mod.load(bytes(elf))
        except elf_mod.ElfError:
            return ERR_BAD_IX_DATA
        if disc == IX_DEPLOY:
            # allocate to max_data_len (the sizing contract Upgrade
            # bounds against)
            body = bytes(elf) + bytes(max_data_len - len(elf))
        else:
            alloc = len(pdata.data) - PROGRAMDATA_META_SZ
            body = bytes(elf) + bytes(alloc - len(elf))
        pdata.data = programdata_state(ic.ctx.slot,
                                       ic.key(auth_i)) + body
        if disc == IX_DEPLOY:
            prog.data = program_state(ic.key(pdata_i))
            prog.executable = True
        buf.data = struct.pack("<I", ST_UNINIT)   # buffer consumed
        return OK

    return ERR_UNKNOWN_IX


def resolve_program_elf(db, xid, program_acct) -> bytes | None:
    """program account -> its ELF bytes through the programdata
    indirection (the execution-path dereference)."""
    try:
        st, info = parse_state(program_acct.data)
    except ValueError:
        return None
    if st != ST_PROGRAM:
        return None
    pd = db.peek(xid, info["programdata"])
    if pd is None or pd.owner != BPF_UPGRADEABLE_LOADER_ID:
        return None
    try:
        pst, pinfo = parse_state(pd.data)
    except ValueError:
        return None
    if pst != ST_PROGRAMDATA:
        return None
    return pinfo["elf"]
