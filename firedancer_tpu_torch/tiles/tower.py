"""Tower frames (copy of `pack_block` of the JAX package's
tiles/tower.py:33; the tower tile itself, `TowerCore` on choreo, is
ROADMAP.md queue A item 13).

Replay's notification of a replayed block, on the replay -> tower link:
  u8 0 BLOCK: u64 slot | u64 parent_slot | 32 block_id | 32 parent_id
"""
from __future__ import annotations

import struct

FRAME_BLOCK = 0


def pack_block(slot: int, parent_slot: int, block_id: bytes,
               parent_id: bytes) -> bytes:
    return (bytes([FRAME_BLOCK]) + struct.pack("<QQ", slot, parent_slot)
            + block_id + parent_id)


def parse_block(frame: bytes):
    """-> (slot, parent_slot, block_id, parent_id) of a BLOCK frame."""
    if frame[0] != FRAME_BLOCK:
        raise ValueError(f"not a BLOCK frame (type {frame[0]})")
    slot, parent_slot = struct.unpack_from("<QQ", frame, 1)
    return slot, parent_slot, bytes(frame[17:49]), bytes(frame[49:81])
