"""Address lookup tables, the read half: the table state and v0
address resolution (the port's copy of the JAX package's svm/alut.py:
`AlutState`, `derive_table_address`, `AlutResolveError`,
`resolve_loaded_keys`).

The reference resolves v0 transactions' table-loaded addresses in the
resolv tile (src/discof/resolv/); the resolv tile here does the same
against the shm account store. The ALUT program itself (Create, Extend,
Deactivate, Close, `exec_alut`) and its instruction builders are
ROADMAP.md queue A item 15: svm/programs.py refuses the program.

State layout (Agave's, via the bincode codec): u32 discriminant
(0 uninitialized, 1 lookup table) | deactivation_slot u64 |
last_extended_slot u64 | last_extended_start_index u8 |
Option<authority Pubkey> | u16 padding, then raw 32-byte addresses
from byte 56 (LOOKUP_TABLE_META_SIZE)."""
from __future__ import annotations

import struct

from .programs import ALUT_PROGRAM_ID, find_program_address

LOOKUP_TABLE_META_SIZE = 56
MAX_ADDRESSES = 256
SLOT_MAX = (1 << 64) - 1


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


def derive_table_address(authority: bytes, recent_slot: int):
    """(table_pda, bump): Agave derives the table account as a PDA of
    [authority, recent_slot_le] under the ALUT program."""
    return find_program_address(
        [authority, recent_slot.to_bytes(8, "little")], ALUT_PROGRAM_ID)


# ---------------------------------------------------------------------------
# v0 resolution (the resolv tile's job)
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
