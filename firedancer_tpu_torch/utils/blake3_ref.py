"""BLAKE3 host oracle: hashing + XOF, pure python (copy of the JAX
package's utils/blake3_ref.py).

Clean-room from the BLAKE3 spec structure (chunked chaining values,
left-leaning binary parent tree, 7-round compression over a 16-word
state with the fixed message permutation). The reference's C tree is
src/ballet/blake3/fd_blake3_ref.c; this oracle gates the batched
kernel and its plain version (ops/blake3.py) and feeds lthash (XOF-2048,
ref: src/ballet/lthash/fd_lthash.h:1-30).
"""
from __future__ import annotations

import struct

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

CHUNK_LEN = 1024
BLOCK_LEN = 64
_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv, block_words, counter, block_len, flags):
    """-> 16 output words (out[:8] = next cv / digest words)."""
    v = list(cv) + list(IV[:4]) + [
        counter & _M32, (counter >> 32) & _M32, block_len, flags]
    m = list(block_words)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in MSG_PERM]
    return [(v[i] ^ v[i + 8]) & _M32 for i in range(8)] + \
           [(v[i + 8] ^ cv[i]) & _M32 for i in range(8)]


def _words(b: bytes) -> list[int]:
    b = b + bytes(BLOCK_LEN - len(b))
    return list(struct.unpack("<16I", b))


def _chunk_cv(chunk: bytes, counter: int, last_flags: int = 0):
    """Chaining value of one chunk; last block gets last_flags extra.
    Returns (cv8, last_block_words, last_block_len, last_flags_full) so
    a single-chunk root can re-run the final compress with ROOT."""
    blocks = [chunk[i:i + BLOCK_LEN]
              for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    cv = list(IV)
    for bi, blk in enumerate(blocks):
        flags = (CHUNK_START if bi == 0 else 0) | \
                (CHUNK_END if bi == len(blocks) - 1 else 0)
        if bi == len(blocks) - 1:
            flags |= last_flags
            return (compress(cv, _words(blk), counter, len(blk), flags),
                    _words(blk), len(blk), flags, cv)
        cv = compress(cv, _words(blk), counter, len(blk), flags)[:8]
    raise AssertionError


def _tree_root(data: bytes):
    """-> (cv_input, block_words, block_len, flags, counter) of the ROOT
    compression (pre-ROOT-flag), following the left-leaning tree."""
    n_chunks = max(1, -(-len(data) // CHUNK_LEN))
    if n_chunks == 1:
        _, words, blen, flags, cv_in = _chunk_cv(data, 0)
        return cv_in, words, blen, flags
    # chunk cvs, then left-leaning parent merges
    cvs = []
    for c in range(n_chunks):
        out = _chunk_cv(data[c * CHUNK_LEN:(c + 1) * CHUNK_LEN], c)
        cvs.append(out[0][:8])

    def merge(nodes):
        # largest power of two < len splits left-leaning
        while len(nodes) > 2:
            nxt = []
            i = 0
            while i + 1 < len(nodes):
                words = nodes[i] + nodes[i + 1]
                nxt.append(compress(list(IV), words, 0, BLOCK_LEN,
                                    PARENT)[:8])
                i += 2
            if i < len(nodes):
                nxt.append(nodes[i])
            nodes = nxt
        return nodes

    # NOTE: BLAKE3's tree is left-leaning (left subtree = largest power
    # of two <= n/2 rounded to power of 2); for n_chunks a power of two
    # the level-by-level merge above is identical. For non-power-of-two
    # counts the spec keeps incomplete right siblings UNMERGED until
    # their level completes — the level merge with odd tail carry
    # matches that.
    nodes = merge(cvs)
    words = nodes[0] + nodes[1]
    return list(IV), words, BLOCK_LEN, PARENT


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash with XOF extension (out_len bytes)."""
    cv, words, blen, flags = _tree_root(data)
    out = b""
    counter = 0
    while len(out) < out_len:
        o = compress(cv, words, counter, blen, flags | ROOT)
        out += struct.pack("<16I", *o)
        counter += 1
    return out[:out_len]


def lthash(data: bytes) -> bytes:
    """2048-byte lattice hash element of `data` (blake3 XOF-2048,
    ref: src/ballet/lthash/fd_lthash.h FD_LTHASH_LEN_BYTES)."""
    return blake3(data, out_len=2048)
