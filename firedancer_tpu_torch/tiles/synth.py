"""Synthetic transaction load generator (copy of the JAX package's
tiles/synth.py; ref: src/app/shared_dev/commands/bench/fd_benchg_tile.c,
pre-signed txn spam for end-to-end TPS measurement)."""
from __future__ import annotations

import hashlib

import numpy as np

from ..protocol.txn import build_message, build_txn
from ..runtime import Ring

SYSTEM_PROGRAM_ID = bytes(32)     # base58 "11111111111111111111111111111111"


def make_signed_txns(n: int, seed: int = 0,
                     signer=None) -> list[bytes]:
    """Build n distinct valid single-signer transactions.

    `signer(seed_bytes, msg) -> (pub, sig)` defaults to the pure-python
    RFC 8032 reference signer."""
    if signer is None:
        from ..utils.ed25519_ref import keypair, sign

        def signer(seed_bytes, msg):
            _, _, pub = keypair(seed_bytes)
            return pub, sign(seed_bytes, msg)

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key_seed = synth_signer_seed(i)
        blockhash = hashlib.sha256(b"hash-%d" % seed).digest()
        dest = hashlib.sha256(b"dest-%d" % i).digest()
        # system-program Transfer: u32 discriminant 2 + u64 lamports
        data = b"\x02\x00\x00\x00" \
            + int(rng.integers(1 << 20, 1 << 31)).to_bytes(8, "little")
        pub, _ = signer(key_seed, b"")
        msg = build_message([pub], [dest, SYSTEM_PROGRAM_ID], blockhash,
                            [(2, bytes([0, 1]), data)], n_ro_unsigned=1)
        _, sig = signer(key_seed, msg)
        out.append(build_txn([sig], msg))
    return out


def synth_signer_seed(i: int) -> bytes:
    """Deterministic signer seeds (16 distinct keys)."""
    return hashlib.sha256(b"synth-%d" % (i % 16)).digest()


class SynthTile:
    """Publishes pre-built txns into a ring as fast as credits allow."""

    def __init__(self, out_ring: Ring, txns: list[bytes]):
        self.out_ring, self.txns = out_ring, txns

    def run(self, count: int, fseqs=None):
        for i in range(count):
            if fseqs:
                while self.out_ring.credits(fseqs) <= 0:
                    pass
            t = self.txns[i % len(self.txns)]
            self.out_ring.publish(t, sig=i)
