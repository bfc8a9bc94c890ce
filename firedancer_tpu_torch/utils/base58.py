"""Base58 encode/decode (Bitcoin alphabet), fixed- and variable-size
(copy of the JAX package's utils/base58.py).

Host-side utility mirroring the reference's fd_base58
(ref: src/ballet/base58/fd_base58.h — fixed-size fast paths for the two
sizes Solana uses: 32-byte account addresses/hashes and 64-byte
signatures). Display/RPC-path code, not hot-path: a clean bignum
implementation is appropriate here; the reference's unrolled
intermediate-limb optimization matters only for its CPU budget.
"""
from __future__ import annotations

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}

# max encoded lengths for the fixed sizes (ref: fd_base58.h FD_BASE58_
# ENCODED_{32,64}_SZ — 44 and 88 chars + nul)
ENCODED_32_MAX = 44
ENCODED_64_MAX = 88


def b58_encode(data: bytes) -> str:
    n_zeros = len(data) - len(data.lstrip(b"\0"))
    v = int.from_bytes(data, "big")
    out = []
    while v:
        v, r = divmod(v, 58)
        out.append(ALPHABET[r])
    return "1" * n_zeros + "".join(reversed(out))


def b58_decode(s: str, out_len: int | None = None) -> bytes:
    v = 0
    for c in s:
        if c not in _INDEX:
            raise ValueError(f"invalid base58 char {c!r}")
        v = v * 58 + _INDEX[c]
    n_ones = len(s) - len(s.lstrip("1"))
    body = v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""
    out = b"\0" * n_ones + body
    if out_len is not None:
        if len(out) > out_len:
            raise ValueError("decoded value too large for out_len")
        out = b"\0" * (out_len - len(out)) + out
    return out


def b58_encode_32(data: bytes) -> str:
    assert len(data) == 32
    return b58_encode(data)


def b58_encode_64(data: bytes) -> str:
    assert len(data) == 64
    return b58_encode(data)


def b58_decode_32(s: str) -> bytes:
    if len(s) > ENCODED_32_MAX:
        raise ValueError("too long for 32-byte value")
    return b58_decode(s, 32)


def b58_decode_64(s: str) -> bytes:
    if len(s) > ENCODED_64_MAX:
        raise ValueError("too long for 64-byte value")
    return b58_decode(s, 64)
