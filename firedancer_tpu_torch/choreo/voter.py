"""Vote-account ("voter") accessors — direct-offset reads of the
serialized vote state, the analog of the reference's zero-copy struct
casts (copy of the JAX package's choreo/voter.py; ref: src/choreo/voter/fd_voter.h:22-100).

The consensus stack reads three things from a vote account on the hot
path — the latest vote slot, the root slot, and the tower — and the
reference does so without a full deserialize by exploiting the fixed
bincode layout:

    u32  kind                    (1 = V1_14_11 / "V2", 2 = current / "V3")
    32B  node_pubkey
    32B  authorized_withdrawer
    u8   commission
    u64  votes_cnt
    votes_cnt x {  u64 slot, u32 conf }            (V2, stride 12)
                {  u8 latency, u64 slot, u32 conf } (V3, stride 13)
    u8   root_option  [u64 root]

The full decode path stays in flamenco/types.py (byte-pinned there);
these accessors read only the prefix above and never allocate the tail.
"""
from __future__ import annotations

import struct

V2 = 1          # VoteStateVersions::V1_14_11
V3 = 2          # VoteStateVersions::Current

_HDR = 4 + 32 + 32 + 1          # kind + node_pubkey + withdrawer + commission
_STRIDE = {V2: 12, V3: 13}
_SLOT_OFF = {V2: 0, V3: 1}      # V3 entries lead with the latency byte


class VoterError(ValueError):
    pass


def _kind_cnt(data: bytes) -> tuple[int, int, int]:
    if len(data) < _HDR + 8:
        raise VoterError("vote account too short")
    kind = struct.unpack_from("<I", data, 0)[0]
    if kind not in _STRIDE:
        raise VoterError(f"unsupported vote state kind {kind}")
    cnt = struct.unpack_from("<Q", data, _HDR)[0]
    if cnt > 64:
        raise VoterError(f"implausible tower length {cnt}")
    end = _HDR + 8 + cnt * _STRIDE[kind]
    if len(data) < end + 1:
        raise VoterError("vote account truncated")
    return kind, cnt, end


def kind(data: bytes) -> int:
    return _kind_cnt(data)[0]


def node_pubkey(data: bytes) -> bytes:
    _kind_cnt(data)
    return bytes(data[4:36])


def last_vote_slot(data: bytes) -> int | None:
    """Most recent vote slot in the tower, None if empty
    (the reference returns ULONG_MAX)."""
    k, cnt, _ = _kind_cnt(data)
    if not cnt:
        return None
    off = _HDR + 8 + (cnt - 1) * _STRIDE[k] + _SLOT_OFF[k]
    return struct.unpack_from("<Q", data, off)[0]


def root_slot(data: bytes) -> int | None:
    k, cnt, end = _kind_cnt(data)
    if not data[end]:
        return None
    if len(data) < end + 9:
        raise VoterError("vote account truncated at root")
    return struct.unpack_from("<Q", data, end + 1)[0]


def tower(data: bytes) -> list[tuple[int, int]]:
    """[(slot, confirmation_count)] oldest-first."""
    k, cnt, _ = _kind_cnt(data)
    stride, soff = _STRIDE[k], _SLOT_OFF[k]
    out = []
    for i in range(cnt):
        off = _HDR + 8 + i * stride + soff
        slot = struct.unpack_from("<Q", data, off)[0]
        conf = struct.unpack_from("<I", data, off + 8)[0]
        out.append((slot, conf))
    return out
