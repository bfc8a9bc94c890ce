"""Solana merkle shred wire format — pack / parse / offset algebra (copy
of the JAX package's shred/format.py).

Layout contract (ref: src/ballet/shred/fd_shred.h:9-35, 183-260):

    [0x00] signature            64B   ed25519 over the FEC-set merkle root
    [0x40] variant               1B   type nibble | proof-node count
    [0x41] slot                  8B   le
    [0x49] idx                   4B   le   shred index within slot
    [0x4d] version               2B   le   shred version (chain id hash)
    [0x4f] fec_set_idx           4B   le
    data:  parent_off 2B | flags 1B | size 2B           (header = 0x58)
    code:  data_cnt   2B | code_cnt 2B | idx 2B         (header = 0x59)
    payload ...
    [chained merkle root 32B]                 (chained variants)
    [proof: cnt x 20B nodes]                  (merkle variants)
    [retransmitter signature 64B]             (resigned variants)

Merkle data shreds are always SHRED_MIN_SZ=1203 bytes on the wire; code
shreds are always SHRED_MAX_SZ=1228 (fd_shred.h:292-299). The variant's
low nibble is the number of non-root proof nodes (fd_shred.h:315-324);
chain/merkle offsets are computed back from the end of the shred
(fd_shred.h:385-394, 434-443).

This is the host-side format layer (wire bytes in numpy/python); the
batched device ops (leaf hashing, RS parity) consume the payload
regions it defines.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

SHRED_MAX_SZ = 1228
SHRED_MIN_SZ = 1203
DATA_HEADER_SZ = 0x58
CODE_HEADER_SZ = 0x59
SIGNATURE_SZ = 64
MERKLE_ROOT_SZ = 32
MERKLE_NODE_SZ = 20
VARIANT_OFF = 0x40

# type nibbles (high 4 bits of the variant byte, fd_shred.h:105-121)
TYPE_LEGACY_DATA = 0xA0
TYPE_LEGACY_CODE = 0x50
TYPE_MERKLE_DATA = 0x80
TYPE_MERKLE_CODE = 0x40
TYPE_MERKLE_DATA_CHAINED = 0x90
TYPE_MERKLE_CODE_CHAINED = 0x60
TYPE_MERKLE_DATA_CHAINED_RESIGNED = 0xB0
TYPE_MERKLE_CODE_CHAINED_RESIGNED = 0x70

TYPEMASK_DATA = TYPE_MERKLE_DATA
TYPEMASK_CODE = TYPE_MERKLE_CODE

# data flags byte (fd_shred.h:142-150)
FLAG_SLOT_COMPLETE = 0x80
FLAG_DATA_COMPLETE = 0x40
REF_TICK_MASK = 0x3F

MAX_SHREDS_PER_SLOT = 1 << 15          # FD_SHRED_BLK_MAX


def shred_type(variant: int) -> int:
    """High nibble, normalized to the FD_SHRED_TYPE_* values."""
    return variant & 0xF0


def is_data(variant: int) -> bool:
    t = shred_type(variant)
    return bool(t & TYPEMASK_DATA) and t != TYPE_LEGACY_CODE


def is_code(variant: int) -> bool:
    return not is_data(variant)


def is_chained(variant: int) -> bool:
    return shred_type(variant) in (
        TYPE_MERKLE_DATA_CHAINED, TYPE_MERKLE_CODE_CHAINED,
        TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED)


def is_resigned(variant: int) -> bool:
    return shred_type(variant) in (
        TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED)


def merkle_cnt(variant: int) -> int:
    """Non-root proof node count (low nibble of merkle variants)."""
    if shred_type(variant) in (TYPE_LEGACY_DATA, TYPE_LEGACY_CODE):
        return 0
    return variant & 0x0F


def shred_sz(variant: int) -> int:
    """Wire size (merkle variants only here; legacy unsupported)."""
    return SHRED_MAX_SZ if is_code(variant) else SHRED_MIN_SZ


def merkle_off(variant: int) -> int:
    """Byte offset of the proof node vector (fd_shred.h:385-394)."""
    return (shred_sz(variant) - MERKLE_NODE_SZ * merkle_cnt(variant)
            - (SIGNATURE_SZ if is_resigned(variant) else 0))


def chain_off(variant: int) -> int:
    """Byte offset of the chained merkle root (fd_shred.h:434-443)."""
    return (shred_sz(variant) - MERKLE_ROOT_SZ
            - MERKLE_NODE_SZ * merkle_cnt(variant)
            - (SIGNATURE_SZ if is_resigned(variant) else 0))


def payload_capacity(variant: int) -> int:
    """Max payload bytes a data shred of this variant can carry
    (1115 - 20*proof_cnt - 32*chained - 64*resigned,
    fd_shredder.c:188)."""
    return (1115 - MERKLE_NODE_SZ * merkle_cnt(variant)
            - (MERKLE_ROOT_SZ if is_chained(variant) else 0)
            - (SIGNATURE_SZ if is_resigned(variant) else 0))


def data_merkle_region_sz(variant: int) -> int:
    """Bytes after the signature covered by this data shred's merkle
    leaf: headers-past-sig + payload capacity + chained root
    (fd_shredder.c:189-190)."""
    return (DATA_HEADER_SZ - SIGNATURE_SZ + payload_capacity(variant)
            + (MERKLE_ROOT_SZ if is_chained(variant) else 0))


def code_merkle_region_sz(variant: int) -> int:
    """Same for code shreds (fd_shredder.c:191)."""
    return data_merkle_region_sz(variant) + CODE_HEADER_SZ - SIGNATURE_SZ


class ShredParseError(ValueError):
    pass


@dataclass(frozen=True)
class DataShred:
    signature: bytes
    variant: int
    slot: int
    idx: int
    version: int
    fec_set_idx: int
    parent_off: int
    flags: int
    size: int                 # header + actual (unpadded) payload bytes
    payload: bytes            # unpadded payload (size - DATA_HEADER_SZ)
    chained_root: bytes | None
    proof: tuple              # proof-node bytes, leaf->root order
    retransmit_sig: bytes | None

    @property
    def ref_tick(self) -> int:
        return self.flags & REF_TICK_MASK

    @property
    def slot_complete(self) -> bool:
        return bool(self.flags & FLAG_SLOT_COMPLETE)

    @property
    def data_complete(self) -> bool:
        return bool(self.flags & FLAG_DATA_COMPLETE)


@dataclass(frozen=True)
class CodeShred:
    signature: bytes
    variant: int
    slot: int
    idx: int
    version: int
    fec_set_idx: int
    data_cnt: int
    code_cnt: int
    code_idx: int
    payload: bytes            # RS parity bytes (full capacity)
    chained_root: bytes | None
    proof: tuple
    retransmit_sig: bytes | None


def _common_hdr(signature: bytes, variant: int, slot: int, idx: int,
                version: int, fec_set_idx: int) -> bytes:
    assert len(signature) == SIGNATURE_SZ
    return signature + struct.pack("<BQIHI", variant, slot, idx, version,
                                   fec_set_idx)


def _tail(buf: bytearray, variant: int, chained_root, proof,
          retransmit_sig):
    if is_chained(variant):
        assert chained_root is not None and len(chained_root) == 32
        off = chain_off(variant)
        buf[off:off + 32] = chained_root
    cnt = merkle_cnt(variant)
    assert len(proof) == cnt, (len(proof), cnt)
    off = merkle_off(variant)
    for i, node in enumerate(proof):
        assert len(node) == MERKLE_NODE_SZ
        buf[off + i * 20:off + (i + 1) * 20] = node
    if is_resigned(variant):
        assert retransmit_sig is not None and len(retransmit_sig) == 64
        buf[-64:] = retransmit_sig


def pack_data_shred(s: DataShred) -> bytes:
    buf = bytearray(SHRED_MIN_SZ)
    buf[:0x53] = _common_hdr(s.signature, s.variant, s.slot, s.idx,
                             s.version, s.fec_set_idx)
    buf[0x53:0x58] = struct.pack("<HBH", s.parent_off, s.flags, s.size)
    cap = payload_capacity(s.variant)
    assert len(s.payload) <= cap
    assert s.size == DATA_HEADER_SZ + len(s.payload)
    buf[0x58:0x58 + len(s.payload)] = s.payload
    _tail(buf, s.variant, s.chained_root, s.proof, s.retransmit_sig)
    return bytes(buf)


def pack_code_shred(s: CodeShred) -> bytes:
    buf = bytearray(SHRED_MAX_SZ)
    buf[:0x53] = _common_hdr(s.signature, s.variant, s.slot, s.idx,
                             s.version, s.fec_set_idx)
    buf[0x53:0x59] = struct.pack("<HHH", s.data_cnt, s.code_cnt, s.code_idx)
    cap = payload_capacity(s.variant) + DATA_HEADER_SZ - SIGNATURE_SZ
    assert len(s.payload) == cap, (len(s.payload), cap)
    buf[0x59:0x59 + cap] = s.payload
    _tail(buf, s.variant, s.chained_root, s.proof, s.retransmit_sig)
    return bytes(buf)


def parse_shred(b: bytes):
    """Wire bytes -> DataShred | CodeShred, with the same validation
    gates as the reference parser (fd_shred.c fd_shred_parse): exact
    wire size for the variant, size-field bounds, proof fit."""
    if len(b) < VARIANT_OFF + 1:
        raise ShredParseError("short")
    variant = b[VARIANT_OFF]
    t = shred_type(variant)
    if t in (TYPE_LEGACY_DATA, TYPE_LEGACY_CODE):
        raise ShredParseError("legacy shreds unsupported")
    if t not in (TYPE_MERKLE_DATA, TYPE_MERKLE_CODE,
                 TYPE_MERKLE_DATA_CHAINED, TYPE_MERKLE_CODE_CHAINED,
                 TYPE_MERKLE_DATA_CHAINED_RESIGNED,
                 TYPE_MERKLE_CODE_CHAINED_RESIGNED):
        raise ShredParseError(f"bad type nibble {t:#x}")
    if len(b) != shred_sz(variant):
        raise ShredParseError("wire size mismatch")
    cnt = merkle_cnt(variant)
    m_off = merkle_off(variant)
    pay_end = chain_off(variant) if is_chained(variant) else m_off
    if pay_end < (DATA_HEADER_SZ if is_data(variant) else CODE_HEADER_SZ):
        raise ShredParseError("proof overruns header")
    signature = b[:64]
    slot, idx, version, fec_set_idx = struct.unpack_from("<QIHI", b, 0x41)
    chained_root = (bytes(b[chain_off(variant):chain_off(variant) + 32])
                    if is_chained(variant) else None)
    proof = tuple(bytes(b[m_off + 20 * i:m_off + 20 * (i + 1)])
                  for i in range(cnt))
    rsig = bytes(b[-64:]) if is_resigned(variant) else None
    if is_data(variant):
        parent_off, flags, size = struct.unpack_from("<HBH", b, 0x53)
        if size < DATA_HEADER_SZ or size > pay_end:
            raise ShredParseError("bad size field")
        return DataShred(signature, variant, slot, idx, version,
                         fec_set_idx, parent_off, flags, size,
                         bytes(b[0x58:size]), chained_root, proof, rsig)
    data_cnt, code_cnt, code_idx = struct.unpack_from("<HHH", b, 0x53)
    if code_idx >= code_cnt or code_cnt == 0 or data_cnt == 0:
        raise ShredParseError("bad code header")
    return CodeShred(signature, variant, slot, idx, version, fec_set_idx,
                     data_cnt, code_cnt, code_idx,
                     bytes(b[0x59:0x59 + payload_capacity(variant)
                             + DATA_HEADER_SZ - SIGNATURE_SZ]),
                     chained_root, proof, rsig)
