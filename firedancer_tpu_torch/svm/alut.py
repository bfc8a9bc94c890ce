"""Address lookup table program + v0 address resolution (copy of the
JAX package's svm/alut.py).

The reference implements the ALUT program in
src/flamenco/runtime/program/fd_address_lookup_table_program.c and
resolves v0 transactions' table-loaded addresses in the resolv tile
(src/discof/resolv/). This module provides both halves for this
runtime: the native program (Create/Extend/Deactivate/Close with the
PDA-derived table address and authority discipline) and
`resolve_loaded_keys`, which the executor calls to extend a v0 txn's
key list past its static accounts — writables first, then readonlys,
exactly the privilege layout the wire encodes.

State layout (Agave's, via the bincode codec): u32 discriminant
(0 uninitialized, 1 lookup table) | deactivation_slot u64 |
last_extended_slot u64 | last_extended_start_index u8 |
Option<authority Pubkey> | u16 padding, then raw 32-byte addresses
from byte 56 (LOOKUP_TABLE_META_SIZE)."""
from __future__ import annotations

import struct

ALUT_PROGRAM_ID = b"AddressLookupTab" + bytes(16)
LOOKUP_TABLE_META_SIZE = 56
MAX_ADDRESSES = 256
SLOT_MAX = (1 << 64) - 1

IX_CREATE = 0
IX_FREEZE = 1
IX_EXTEND = 2
IX_DEACTIVATE = 3
IX_CLOSE = 4


class AlutState:
    def __init__(self, authority: bytes | None,
                 deactivation_slot: int = SLOT_MAX,
                 last_extended_slot: int = 0,
                 last_extended_start: int = 0,
                 addresses: list[bytes] = ()):
        self.authority = authority
        self.deactivation_slot = deactivation_slot
        self.last_extended_slot = last_extended_slot
        self.last_extended_start = last_extended_start
        self.addresses = list(addresses)

    def to_bytes(self) -> bytes:
        out = struct.pack("<IQQB", 1, self.deactivation_slot,
                          self.last_extended_slot,
                          self.last_extended_start)
        if self.authority is None:
            out += b"\x00" + bytes(32)
        else:
            out += b"\x01" + self.authority
        out += bytes(2)                       # padding to 56
        assert len(out) == LOOKUP_TABLE_META_SIZE
        return out + b"".join(self.addresses)

    @classmethod
    def from_bytes(cls, b: bytes) -> "AlutState":
        if len(b) < LOOKUP_TABLE_META_SIZE:
            raise ValueError("short ALUT state")
        disc, deact, last_slot, last_start = struct.unpack_from(
            "<IQQB", b, 0)
        if disc != 1:
            raise ValueError(f"not a lookup table (disc {disc})")
        has_auth = b[21]
        auth = bytes(b[22:54]) if has_auth else None
        body = b[LOOKUP_TABLE_META_SIZE:]
        addrs = [bytes(body[i:i + 32])
                 for i in range(0, len(body) - len(body) % 32, 32)]
        return cls(auth, deact, last_slot, last_start, addrs)

    def is_active(self, slot: int) -> bool:
        return slot <= self.deactivation_slot


def derive_table_address(authority: bytes, recent_slot: int):
    """(table_pda, bump) — Agave derives the table account as a PDA of
    [authority, recent_slot_le] under the ALUT program."""
    from .programs import find_program_address
    return find_program_address(
        [authority, recent_slot.to_bytes(8, "little")], ALUT_PROGRAM_ID)


def ix_create(recent_slot: int, bump: int) -> bytes:
    return struct.pack("<IQB", IX_CREATE, recent_slot, bump)


def ix_extend(addresses: list[bytes]) -> bytes:
    out = struct.pack("<IQ", IX_EXTEND, len(addresses))
    for a in addresses:
        assert len(a) == 32
        out += a
    return out


def ix_deactivate() -> bytes:
    return struct.pack("<I", IX_DEACTIVATE)


def ix_close() -> bytes:
    return struct.pack("<I", IX_CLOSE)


def exec_alut(ic) -> str:
    """Accounts: [table, authority, (payer for create / recipient for
    close)]. The authority must SIGN everything past creation."""
    from .programs import (
        ERR_BAD_IX_DATA, ERR_INVALID_OWNER, ERR_MISSING_SIG,
        ERR_NOT_WRITABLE, ERR_UNKNOWN_IX, OK,
    )
    data = ic.data
    if len(data) < 4 or ic.n < 2:
        return ERR_BAD_IX_DATA
    disc = struct.unpack_from("<I", data, 0)[0]
    table = ic.account(0)
    authority_key = ic.key(1)
    slot = ic.ctx.slot

    if disc == IX_CREATE:
        if len(data) < 13:
            return ERR_BAD_IX_DATA
        recent_slot, bump = struct.unpack_from("<QB", data, 4)
        want, want_bump = derive_table_address(authority_key,
                                               recent_slot)
        if ic.key(0) != want or bump != want_bump:
            return ERR_INVALID_OWNER          # wrong PDA
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if table.owner == ALUT_PROGRAM_ID and table.data:
            return ERR_INVALID_OWNER          # already created
        table.owner = ALUT_PROGRAM_ID
        table.data = AlutState(authority_key).to_bytes()
        return OK

    if table.owner != ALUT_PROGRAM_ID or not table.data:
        return ERR_INVALID_OWNER
    try:
        st = AlutState.from_bytes(table.data)
    except ValueError:
        return ERR_INVALID_OWNER
    if st.authority is None or st.authority != authority_key:
        return ERR_INVALID_OWNER              # frozen or wrong authority
    if not ic.is_signer(1):
        return ERR_MISSING_SIG
    if not ic.is_writable(0):
        return ERR_NOT_WRITABLE

    if disc == IX_FREEZE:
        st.authority = None
        table.data = st.to_bytes()
        return OK

    if disc == IX_EXTEND:
        if len(data) < 12:
            return ERR_BAD_IX_DATA
        (cnt,) = struct.unpack_from("<Q", data, 4)
        if len(data) < 12 + 32 * cnt or cnt == 0:
            return ERR_BAD_IX_DATA
        addrs = [data[12 + 32 * i:12 + 32 * (i + 1)]
                 for i in range(cnt)]
        if len(st.addresses) + cnt > MAX_ADDRESSES:
            return ERR_BAD_IX_DATA
        if st.deactivation_slot != SLOT_MAX:
            return ERR_INVALID_OWNER          # deactivated: frozen set
        st.last_extended_slot = slot
        st.last_extended_start = len(st.addresses)
        st.addresses.extend(addrs)
        table.data = st.to_bytes()
        return OK

    if disc == IX_DEACTIVATE:
        if st.deactivation_slot != SLOT_MAX:
            return ERR_INVALID_OWNER
        st.deactivation_slot = slot
        table.data = st.to_bytes()
        return OK

    if disc == IX_CLOSE:
        if ic.n < 3 or not ic.is_writable(2):
            return ERR_BAD_IX_DATA
        if st.deactivation_slot == SLOT_MAX \
                or slot <= st.deactivation_slot:
            return ERR_INVALID_OWNER          # must be deactivated+cooled
        ic.account(2).lamports += table.lamports
        table.lamports = 0
        table.data = b""
        table.owner = bytes(32)
        return OK

    return ERR_UNKNOWN_IX


# ---------------------------------------------------------------------------
# v0 resolution (the resolv tile's job, executor-side)
# ---------------------------------------------------------------------------

class AlutResolveError(ValueError):
    pass


def resolve_loaded_keys(db, xid, txn, slot: int = 0):
    """v0 txn -> (extra_keys, extra_writable_flags): table-loaded
    addresses in wire order (each table's writables, then each table's
    readonlys — Agave's LoadedAddresses layout). Raises on a missing/
    foreign/deactivated table or an out-of-range index."""
    w_keys: list[bytes] = []
    ro_keys: list[bytes] = []
    for tkey, w_idxs, ro_idxs in txn.aluts:
        acct = db.peek(xid, tkey)
        if acct is None or acct.owner != ALUT_PROGRAM_ID:
            raise AlutResolveError("missing lookup table")
        try:
            st = AlutState.from_bytes(acct.data)
        except ValueError as e:
            raise AlutResolveError(f"malformed lookup table: {e}")
        if not st.is_active(slot):
            raise AlutResolveError("deactivated lookup table")
        for i in w_idxs:
            if i >= len(st.addresses):
                raise AlutResolveError("lookup index out of range")
            w_keys.append(st.addresses[i])
        for i in ro_idxs:
            if i >= len(st.addresses):
                raise AlutResolveError("lookup index out of range")
            ro_keys.append(st.addresses[i])
    keys = w_keys + ro_keys
    flags = [True] * len(w_keys) + [False] * len(ro_keys)
    return keys, flags
