"""JAX-free inputs for the SHA-256, PoH and BLAKE3 kernels' tests: the
host build (tests/test_torch_csrc_host.py) and the card
(tests/test_torch_cuda.py, run there without the suite's conftest) use
the same rows and entries, with their expected outputs from hashlib, the
port's host PoH chain and the port's BLAKE3 oracle."""
import hashlib

import numpy as np

from firedancer_tpu_torch.ops.poh import host_poh_append, host_poh_mixin
from firedancer_tpu_torch.utils import blake3_ref

# SHA-256's extra-block edges (len % 64 in 56..63 spills the bit length)
SHA256_EDGES = (0, 1, 3, 55, 56, 63, 64, 119, 120, 127, 128, 200)
# BLAKE3's block and chunk edges and the two-chunk cap
BLAKE3_EDGES = (0, 1, 3, 63, 64, 65, 1023, 1024, 1025, 2047, 2048)
# the bank hash's account of no data: 8 + 8 + 0 + 1 + 32 + 32 bytes
BLAKE3_BANK_HASH_LEN = 81


def rows(lens, width, seed):
    """(len(lens), width) uint8 rows, random below each length and zero
    past it, and the (n,) int32 lengths (each clipped to width)."""
    lens = np.minimum(np.asarray(lens, np.int64), width).astype(np.int32)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, (len(lens), width), np.uint8)
    msg[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msg, lens


# the row widths of SHA-256's paths (bmtree's leaf and node levels, the
# shred leaves, R || A || M) and one off every alignment
SHA256_WIDTHS = (58, 90, 1070, 1296, 1297)


def offset_rows(lens, width, offset, seed):
    """rows() whose first byte lies `offset` bytes past an aligned buffer
    start: (n, width) uint8 view of a larger buffer, and the lengths."""
    msg, lens = rows(lens, width, seed)
    flat = np.zeros(msg.size + offset + 16, np.uint8)
    flat = flat[(-flat.ctypes.data) % 16:]          # 16-aligned start
    view = flat[offset:offset + msg.size].reshape(msg.shape)
    view[:] = msg
    return view, lens


def sha256_want(msg, lens):
    return np.stack([np.frombuffer(hashlib.sha256(
        msg[i, :n].tobytes()).digest(), np.uint8) for i, n in enumerate(lens)])


def blake3_want(msg, lens):
    return np.stack([np.frombuffer(blake3_ref.blake3(
        msg[i, :n].tobytes()), np.uint8) for i, n in enumerate(lens)])


def lthash_want(msg, lens):
    return np.stack([np.frombuffer(blake3_ref.lthash(
        msg[i, :n].tobytes()), np.uint16).astype(np.int32)
        for i, n in enumerate(lens)])


def poh_entries(max_hashes, seed=0, reps=1):
    """PoH entries of every class, `reps` chains of them: ticks and mixin
    entries (valid), a mixin entry of one hash, entries of 0 hashes
    (never valid), entries with more plain hashes than max_hashes (valid
    only against the chain clipped at max_hashes, as the reference's scan
    bound clips it) and one flipped byte in expected.
    -> ((prev, num, mixin, has, expected) arrays, (N,) expected verdicts)."""
    rng = np.random.default_rng(seed)
    rows_, want = [], []
    for _ in range(reps):
        state = rng.bytes(32)
        for num, has in ((5, False), (3, True), (1, True), (max_hashes,
                                                            False),
                         (max_hashes, True), (2, False)):
            mix = rng.bytes(32) if has else None
            s = host_poh_append(state, num - 1 if has else num)
            end = host_poh_mixin(s, mix) if has else s
            rows_.append((state, num, mix, end))
            want.append(True)
            state = end
        mix = rng.bytes(32)
        clipped = host_poh_append(state, max_hashes)
        good = host_poh_append(state, 4)
        for row, ok in (
                ((state, 0, None, state), False),
                ((state, 0, mix, host_poh_mixin(state, mix)), False),
                ((state, max_hashes + 9, None, clipped), True),
                ((state, max_hashes + 9, None,
                  host_poh_append(state, max_hashes + 9)), False),
                ((state, max_hashes + 3, mix, host_poh_mixin(clipped, mix)),
                 True),
                ((state, 4, None, bytes([good[0] ^ 1]) + good[1:]), False),
                ((state, 4, None, good[:31] + bytes([good[31] ^ 0x80])),
                 False)):
            rows_.append(row)
            want.append(ok)
    n = len(rows_)
    prev = np.stack([np.frombuffer(r[0], np.uint8) for r in rows_])
    num = np.array([r[1] for r in rows_], np.int32)
    mixin = np.zeros((n, 32), np.uint8)
    has = np.array([r[2] is not None for r in rows_])
    for i, r in enumerate(rows_):
        if r[2] is not None:
            mixin[i] = np.frombuffer(r[2], np.uint8)
    exp = np.stack([np.frombuffer(r[3], np.uint8) for r in rows_])
    return (prev, num, mixin, has, exp), np.array(want)
