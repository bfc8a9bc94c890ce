"""Complete slot slices for the follower's drills: each slot's
transactions as entry batches packed by `tiles/shred.pack_slice`.
tools/exec_drills.py, tools/catchup.py and tools/general_exec.py build
their replay's input here."""
from __future__ import annotations

import hashlib
import struct


def split(txns, n_slots: int) -> dict:
    """txns -> {slot 1..n_slots: an equal share, in order} (a remainder
    past n_slots shares is left out)."""
    per = max(1, len(txns) // n_slots)
    return {s: txns[(s - 1) * per:s * per] for s in range(1, n_slots + 1)}


def _entry(num_hashes: int, state: bytes, txns) -> bytes:
    return struct.pack("<I", num_hashes) + state \
        + struct.pack("<I", len(txns)) + b"".join(
            struct.pack("<H", len(t)) + t for t in txns)


def slot_slices(by_slot: dict, tip_tag: bytes = b"",
                hashes_per_tick: int = 0, entry_txns: int = 32) -> dict:
    """{slot: [payloads]} -> {slot: one complete slice}.

    hashes_per_tick 0: one entry a slot behind a hand-built tip,
    sha256(tip_tag + the slot in decimal), for a replay whose PoH check
    is off (the bank-hash chain is what is held).

    hashes_per_tick > 0: a real PoH chain from a zero state across the
    slots in order: the slot's transactions in entries of `entry_txns`
    (one hash with the entry's mixin, sha256 of the first signatures),
    then one tick entry of `hashes_per_tick` hashes (the replay checks
    every slot whose parent tip it knows)."""
    from ..tiles.shred import pack_slice
    out = {}
    state = bytes(32)
    for s in sorted(by_slot):
        txns = by_slot[s]
        if not hashes_per_tick:
            tip = hashlib.sha256(tip_tag + b"%d" % s).digest()
            out[s] = pack_slice(s, 0, True, _entry(1, tip, txns))
            continue
        batch = b""
        for i in range(0, len(txns), entry_txns):
            group = txns[i:i + entry_txns]
            mixin = hashlib.sha256(b"".join(t[1:65] for t in group)
                                   ).digest()
            state = hashlib.sha256(state + mixin).digest()
            batch += _entry(1, state, group)
        for _ in range(hashes_per_tick):
            state = hashlib.sha256(state).digest()
        batch += _entry(hashes_per_tick, state, [])
        out[s] = pack_slice(s, 0, True, batch)
    return out
