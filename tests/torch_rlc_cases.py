"""Seeded RLC batch inputs shared by the port's tests (imports no JAX, so
tests/test_torch_cuda.py can use it on a machine without JAX)."""
import hashlib

import numpy as np

from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.utils import ed25519_ref as ref
from firedancer_tpu_torch.utils.chaos import undecodable_point


def signed(n: int, msg_len: int, seed: int):
    """n valid RFC 8032 signatures, distinct keys and messages -> sig
    (n, 64), pub (n, 32), msg (n, msg_len) uint8, msg_len (n,) int32."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = rng.integers(0, 256, (n, msg_len), np.uint8)
    for i in range(n):
        key = rng.bytes(32)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, msg[i].tobytes()), np.uint8)
    return sig, pub, msg, np.full(n, msg_len, np.int32)


def k64s(sig, pub, msg, msg_len) -> np.ndarray:
    """(n, 64) uint8: SHA-512(R || A || M) per lane."""
    return np.stack([np.frombuffer(hashlib.sha512(
        bytes(sig[i, :32]) + bytes(pub[i])
        + bytes(msg[i, :msg_len[i]])).digest(), np.uint8)
        for i in range(len(sig))])


KEPT_OUT = (1, 2, 3, 5)      # the lanes of stage_inputs outside lane_ok


def stage_inputs(n: int, seed: int):
    """Stage-1 inputs over n >= 7 lanes with every lane class the kernel
    meets: valid signatures, a non-decodable R (lane 1), a non-decodable
    A (lane 2), S >= l (lane 3), z = 0 (lane 4), a small-order A (lane
    5), z = 2^128 - 1 (lane 6). -> (pub, sig, k64, z) numpy arrays, and
    s (32,) uint8 with s = sum z S mod l over the lanes the kernel keeps
    (all but KEPT_OUT), so the batch verifies."""
    sig, pub, msg, ln = signed(n, 40, seed)
    sig[1, :32] = undecodable_point(seed + 1)
    pub[2] = undecodable_point(seed + 2)
    sig[3, 32:] = np.frombuffer((ed.L + 5).to_bytes(32, "little"), np.uint8)
    pub[5] = ed._small_order_encodings()[1]
    rng = np.random.default_rng(seed + 3)
    z = rng.integers(0, 256, (n, 16), np.uint8)
    z[4] = 0
    z[6] = 0xFF
    s = 0
    for i in range(n):
        if i not in KEPT_OUT:
            s += int.from_bytes(bytes(z[i]), "little") \
                * int.from_bytes(bytes(sig[i, 32:]), "little")
    s = np.frombuffer((s % ed.L).to_bytes(32, "little"), np.uint8).copy()
    return (pub, sig, k64s(sig, pub, msg, ln), z), s


def spread_blocks(wsum, sdig, nblk: int):
    """Stage-1 outputs of 2 blocks (wsum (2, 64, 4, 10) int32, sdig (2, 13)
    int64 tensors) -> the same batch as nblk blocks: block b >= 1 holds
    the valid points of another window's sums (window j + b of block b % 2),
    block 0 the window totals minus all of them, so each window's sum over
    the blocks, s and the batch verdict stay as they were; the digit sums
    go to block 0."""
    import torch
    from firedancer_tpu_torch.ops import fe25519 as fe
    w = wsum.to(torch.int64)
    first = ed._add_full(w[0].unbind(-2), w[1].unbind(-2))
    rest = [w[b % 2].roll(-b, 0) for b in range(1, nblk)]
    for q in rest:
        x, y, z, t = q.unbind(-2)
        first = ed._add_full(first, (fe.neg(x), y, z, fe.neg(t)))
    blocks = torch.stack([torch.stack(first, -2)] + rest).to(torch.int32)
    dig = torch.zeros((nblk, 13), dtype=torch.int64, device=sdig.device)
    dig[0] = sdig.sum(0)
    return blocks, dig


# one lane per precheck class, and whether it passes the prechecks
PRE_CLASSES = (("S = l - 1", 1), ("S = l", 0), ("A.y >= p", 0),
               ("small-order A", 0), ("small-order R", 0), ("valid", 1))


def ram_inputs(msg_len: int, width: int, seed: int):
    """One lane per PRE_CLASSES entry, each with a msg_len-byte message in
    a row of `width` bytes (random bytes past msg_len, which the hash
    must not read) -> sig (6, 64), pub (6, 32), msg (6, width) uint8,
    lens (6,) int32."""
    rng = np.random.default_rng(seed)
    n = len(PRE_CLASSES)
    msg = rng.integers(0, 256, (n, width), np.uint8)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    for i in range(n):
        key = rng.bytes(32)
        pub[i] = np.frombuffer(ref.keypair(key)[2], np.uint8)
        sig[i] = np.frombuffer(ref.sign(key, bytes(msg[i, :msg_len])),
                               np.uint8)
    sig[0, 32:] = np.frombuffer((ed.L - 1).to_bytes(32, "little"), np.uint8)
    sig[1, 32:] = np.frombuffer(ed.L.to_bytes(32, "little"), np.uint8)
    pub[2] = np.frombuffer(((1 << 255) - 16).to_bytes(32, "little"),
                           np.uint8)        # p + 3
    pub[3] = ed._small_order_encodings()[3]
    sig[4, :32] = ed._small_order_encodings()[5]
    return sig, pub, msg, np.full(n, msg_len, np.int32)
