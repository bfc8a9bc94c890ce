"""Precompile programs: ed25519, secp256k1 and secp256r1 signature
verification (copy of the JAX package's svm/precompiles.py). All three
verify on the host, as in the JAX package: the ed25519 precompile runs
utils/ed25519_ref.verify per signature, never the card's batch.

The reference verifies precompile instructions before execution
(ref: src/flamenco/runtime/fd_precompiles.c — fd_precompile_ed25519_
verify / fd_precompile_secp256k1_verify, instruction layouts per the
Agave wire structs). Both programs carry OFFSETS into (possibly other)
instructions' data, so verification reads through the whole message.

ed25519 instruction data:
  u8 count | u8 pad | count x { sig_off u16 | sig_ix u16 |
  pub_off u16 | pub_ix u16 | msg_off u16 | msg_sz u16 | msg_ix u16 }
  (ix 0xFFFF = "this instruction")

secp256k1 instruction data:
  u8 count | count x { sig_off u16 | sig_ix u8 | addr_off u16 |
  addr_ix u8 | msg_off u16 | msg_sz u16 | msg_ix u8 }
  signature = 64 bytes r||s + 1 recovery byte; the 20-byte eth address
  must equal keccak256(recovered_pubkey)[12:].
"""
from __future__ import annotations

import struct

# the REAL base58 ids — shared with the pack cost model so costing
# and dispatch always agree on what is a precompile
from ..pack.cost import (
    ED25519_SV_PROGRAM_ID as ED25519_PROGRAM_ID,
    KECCAK_SECP_PROGRAM_ID as SECP256K1_PROGRAM_ID,
    SECP256R1_PROGRAM_ID,
)

THIS_IX = 0xFFFF          # u16 marker (ed25519 layout)
THIS_IX_U8 = 0xFF         # u8 marker (secp256k1 layout)


def _instr_data(ctx, idx: int, this_data: bytes,
                marker: int) -> bytes | None:
    """marker is LAYOUT-SPECIFIC: 0xFFFF for the u16 ed25519 indexes,
    0xFF for the u8 secp256k1 indexes — 0x00FF is a REAL index in the
    u16 layout and must bounds-check like any other."""
    if idx == marker:
        return this_data
    if idx >= len(ctx.txn.instrs):
        return None
    ins = ctx.txn.instrs[idx]
    return ctx.payload[ins.data_off:ins.data_off + ins.data_sz]


def _slice(data: bytes | None, off: int, sz: int) -> bytes | None:
    if data is None or off + sz > len(data):
        return None
    return data[off:off + sz]


def exec_ed25519_precompile(ic) -> str:
    from ..utils.ed25519_ref import verify
    from .programs import ERR_BAD_IX_DATA, ERR_VM, OK
    data = ic.data
    if len(data) < 2:
        return ERR_BAD_IX_DATA
    count = data[0]
    need = 2 + 14 * count
    if len(data) < need:
        return ERR_BAD_IX_DATA
    for i in range(count):
        (sig_off, sig_ix, pub_off, pub_ix, msg_off, msg_sz,
         msg_ix) = struct.unpack_from("<HHHHHHH", data, 2 + 14 * i)
        sig = _slice(_instr_data(ic.ctx, sig_ix, data, THIS_IX),
                     sig_off, 64)
        pub = _slice(_instr_data(ic.ctx, pub_ix, data, THIS_IX),
                     pub_off, 32)
        msg = _slice(_instr_data(ic.ctx, msg_ix, data, THIS_IX),
                     msg_off, msg_sz)
        if sig is None or pub is None or msg is None:
            return ERR_BAD_IX_DATA
        if not verify(sig, pub, msg):
            ic.logs.append(f"ed25519 precompile: sig {i} invalid")
            return ERR_VM
    return OK


def exec_secp256k1_precompile(ic) -> str:
    from ..utils.keccak import keccak256
    from ..utils.secp256k1 import eth_address, recover
    from .programs import ERR_BAD_IX_DATA, ERR_VM, OK
    data = ic.data
    if len(data) < 1:
        return ERR_BAD_IX_DATA
    count = data[0]
    need = 1 + 11 * count
    if len(data) < need:
        return ERR_BAD_IX_DATA
    for i in range(count):
        (sig_off, sig_ix, addr_off, addr_ix, msg_off, msg_sz,
         msg_ix) = struct.unpack_from("<HBHBHHB", data, 1 + 11 * i)
        sig = _slice(_instr_data(ic.ctx, sig_ix, data, THIS_IX_U8),
                     sig_off, 65)
        addr = _slice(_instr_data(ic.ctx, addr_ix, data, THIS_IX_U8),
                     addr_off, 20)
        msg = _slice(_instr_data(ic.ctx, msg_ix, data, THIS_IX_U8),
                     msg_off, msg_sz)
        if sig is None or addr is None or msg is None:
            return ERR_BAD_IX_DATA
        r = int.from_bytes(sig[0:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        q = recover(keccak256(msg), r, s, sig[64])
        if q is None or eth_address(q) != addr:
            ic.logs.append(f"secp256k1 precompile: sig {i} invalid")
            return ERR_VM
    return OK


def exec_secp256r1_precompile(ic) -> str:
    """SIMD-0075 P-256 precompile: same 14-byte offsets entry as the
    ed25519 layout (u16 indexes, 0xFFFF = this instruction), 33-byte
    SEC1 compressed pubkeys, 64-byte r‖s signatures with the low-s
    rule (ref: src/ballet/secp256r1/)."""
    from ..utils.secp256r1 import verify
    from .programs import ERR_BAD_IX_DATA, ERR_VM, OK
    data = ic.data
    if len(data) < 2:
        return ERR_BAD_IX_DATA
    count = data[0]
    # SIMD-0075: num_signatures MUST be 1..=8 (the reference rejects
    # out-of-range counts; agreeing here is consensus-critical)
    if count == 0 or count > 8:
        return ERR_BAD_IX_DATA
    need = 2 + 14 * count
    if len(data) < need:
        return ERR_BAD_IX_DATA
    for i in range(count):
        (sig_off, sig_ix, pub_off, pub_ix, msg_off, msg_sz,
         msg_ix) = struct.unpack_from("<HHHHHHH", data, 2 + 14 * i)
        sig = _slice(_instr_data(ic.ctx, sig_ix, data, THIS_IX),
                     sig_off, 64)
        pub = _slice(_instr_data(ic.ctx, pub_ix, data, THIS_IX),
                     pub_off, 33)
        msg = _slice(_instr_data(ic.ctx, msg_ix, data, THIS_IX),
                     msg_off, msg_sz)
        if sig is None or pub is None or msg is None:
            return ERR_BAD_IX_DATA
        if not verify(pub, msg, sig):
            ic.logs.append(f"secp256r1 precompile: sig {i} invalid")
            return ERR_VM
    return OK
