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
