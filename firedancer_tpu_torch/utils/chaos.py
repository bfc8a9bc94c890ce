"""Adversarial traffic for the verify tile's front door: the port's copy of
the transaction floods of the JAX package's utils/chaos.py (attack_frames,
_txn_pool, torsion_sign and its torsion point), and an undecodable point
encoding.

Each flood pre-renders a small pool of hostile payloads (the host crypto
runs once) that attack_frames replays to the requested count.
Deterministic in (action, seed), and byte-equal to the reference's. Not
ported: the fault plans (ChaosPlan; ROADMAP.md queue A, item 2) and the
QUIC and CRDS floods, whose doors are not ported either (items 1, 3).
"""
from __future__ import annotations

import hashlib

import numpy as np

TRAFFIC_ACTIONS = ("flood_forged", "flood_torsion", "flood_dup",
                   "flood_malformed_quic", "flood_crds_spam")
_PORTED = ("flood_forged", "flood_torsion", "flood_dup")

_POOL = 8           # distinct payloads per action pool


def _torsion_point():
    """A nonzero 8-torsion point in host-reference arithmetic: clear the
    prime-order component of an arbitrary curve point ([L]P lies in
    E[8]) until the torsion part has exact order 8."""
    from . import ed25519_ref as ref
    for i in range(256):
        y = int.from_bytes(hashlib.sha256(b"tors-%d" % i).digest(),
                           "little") % ref.P
        pt = ref.pt_decompress(y.to_bytes(32, "little"))
        if pt is None:
            continue
        t = ref.pt_mul(ref.L, pt)
        zi = pow(t[2], ref.P - 2, ref.P)
        if (t[0] * zi % ref.P, t[1] * zi % ref.P) == (0, 1):
            continue                     # pure prime-order point
        # exact order 8: [4]T is not the identity
        q = ref.pt_mul(4, t)
        zi = pow(q[2], ref.P - 2, ref.P)
        if (q[0] * zi % ref.P, q[1] * zi % ref.P) != (0, 1):
            return t
    raise AssertionError("no order-8 torsion point found")


def torsion_sign(seed_bytes: bytes, msg: bytes) -> tuple[bytes, bytes]:
    """RLC-evasion forgery with one's own key: R* = rB + T with T pure
    8-torsion, S = r + k a. The scalar relation holds, so the batch
    residual is exactly -z T: strict (cofactorless) verification always
    rejects, and the cofactored batch equation accepts iff z = 0 mod 8.
    Returns (pub, sig)."""
    from . import ed25519_ref as ref
    a, prefix, pub = ref.keypair(seed_bytes)
    r = int.from_bytes(hashlib.sha512(prefix + b"t" + msg).digest(),
                       "little") % ref.L
    r_star = ref.pt_add(ref.pt_mul(r, ref.BASEPOINT), _torsion_point())
    rb = ref.pt_compress(r_star)
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(),
                       "little") % ref.L
    s = (r + k * a) % ref.L
    return pub, rb + s.to_bytes(32, "little")


def _txn_pool(action: str, n: int, seed: int) -> list[bytes]:
    from ..tiles.synth import make_signed_txns
    if action == "flood_dup":
        # duplicate storm: ONE valid txn, every replay is dedup work
        return make_signed_txns(1, seed=seed)
    if action == "flood_torsion":
        return make_signed_txns(n, seed=seed, signer=torsion_sign)
    txns = make_signed_txns(n, seed=seed)
    out = []
    for i, t in enumerate(txns):
        bad = bytearray(t)
        # corrupt inside the signature AND the message so that each
        # frame's dedup tag is its own
        bad[5 + (i % 32)] ^= 0x40
        bad[-1 - (i % 8)] ^= 0x01
        out.append(bytes(bad))
    return out


def undecodable_point(seed: int) -> np.ndarray:
    """(32,) uint8 with y < p for which x^2 = (y^2 - 1)/(d y^2 + 1) has
    no root: it passes every byte check and fails decompression (about
    half of all random point bytes do)."""
    from . import ed25519_ref as ref
    rng = np.random.default_rng(seed)
    while True:
        b = bytearray(rng.bytes(32))
        b[31] &= 0x3F                                  # y < 2^254 < p
        if ref.pt_decompress(bytes(b)) is None:
            return np.frombuffer(bytes(b), np.uint8).copy()


def attack_frames(action: str, frames: int, seed: int = 0) -> list[bytes]:
    """`frames` hostile payloads for a transaction flood, replayed from a
    pool of at most 8 distinct ones."""
    if action not in TRAFFIC_ACTIONS:
        raise ValueError(f"unknown traffic action {action!r}")
    if action not in _PORTED:
        raise NotImplementedError(f"{action}: its door is not ported "
                                  f"(ROADMAP.md queue A, items 1 and 3)")
    if frames <= 0:
        return []
    pool = _txn_pool(action, min(frames, _POOL), seed)
    return [pool[i % len(pool)] for i in range(frames)]
