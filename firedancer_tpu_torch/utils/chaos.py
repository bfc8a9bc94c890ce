"""Chaos harness: seeded, deterministic fault plans for tile topologies,
and adversarial traffic for the verify tile's and the gossip tile's front
doors (copy of the JAX package's utils/chaos.py: ChaosPlan,
ChaosDeviceError, the ACTIONS tuples, attack_frames, _txn_pool,
malformed_quic_datagrams, crds_spam_datagrams, torsion_sign and its
torsion point, plus an undecodable point encoding).

A fault plan is plain data in a tile's args (`chaos = {...}`), flows
through the topology plan like any other arg, and fires inside the tile
process:

    {"seed": 7,                   # derives any randomized trigger points
     "rearm": false,              # true: the plan survives a respawn
     "events": [
       {"action": "crash",       "at_rx": 8, "code": 9}, # after 8 frags
       {"action": "freeze_hb",   "at_iter": [100, 200]}, # seeded range
       {"action": "wedge",       "at_rx": 4},            # stop polling
       {"action": "stall_fseq",  "at_rx": 4, "link": "a_b"},
       {"action": "fail_dispatch", "count": 3},          # verify tile
       {"action": "fail_dispatch", "count": -1},         # persistent
       {"action": "flood_forged", "at_iter": 6, "frames": 24},
       {"action": "flood_crds_spam", "at_iter": 6, "frames": 512},
       {"action": "diverge_block", "at_rx": 3},          # replay tile
     ]}

`at_iter` counts stem loop iterations, `at_rx` frags consumed; a
two-element list is a seeded-uniform pick in [lo, hi]. Each event fires
at most once per process. The stem runs crash, freeze_hb, wedge and
stall_fseq (STEM_ACTIONS) itself and hands every other action to the
tile adapter's `on_chaos` after recording it (disco/stem.py); the
verify tile consumes `fail_dispatch` (tiles/verify.py), the gossip tile
`flood_crds_spam` (disco/tiles.GossipAdapter), the quic tile
`flood_malformed_quic` (disco/tiles.QuicAdapter). The same spec gives the same firing points and attack bytes as the reference.

The floods pre-render a small pool of hostile payloads (the host crypto
runs once) that attack_frames replays to the requested count, byte-equal
to the reference's. The snapshot drills go to snapld's adapter
(crash_mid_snapshot, corrupt_checkpt_frame, stale_snapshot_offer) and
the replay's (crash_mid_snapshot on its snapshot writer, diverge_block).
"""
from __future__ import annotations

import hashlib
import random

import numpy as np

STEM_ACTIONS = ("crash", "freeze_hb", "wedge", "stall_fseq")
TRAFFIC_ACTIONS = ("flood_forged", "flood_torsion", "flood_dup",
                   "flood_malformed_quic", "flood_crds_spam")
# snapshot/replay robustness drills: adapter-routed, like traffic
SNAPSHOT_ACTIONS = ("crash_mid_snapshot", "corrupt_checkpt_frame",
                    "stale_snapshot_offer", "diverge_block")
ACTIONS = STEM_ACTIONS + ("fail_dispatch",) + TRAFFIC_ACTIONS \
    + SNAPSHOT_ACTIONS

_POOL = 8           # distinct payloads per action pool


class ChaosPlan:
    """Parsed fault plan. One instance per tile process; `poll` is
    called from the stem loop, `take_dispatch_failure` from the verify
    tile's device-dispatch wrapper."""

    def __init__(self, spec: dict):
        if not isinstance(spec, dict):
            raise ValueError(f"chaos spec must be a dict, got {spec!r}")
        rng = random.Random(int(spec.get("seed", 0)))
        self.events: list[dict] = []
        self._dispatch_failures = 0        # -1 = unbounded
        for ev in spec.get("events", []):
            act = ev.get("action")
            if act not in ACTIONS:
                raise ValueError(f"unknown chaos action {act!r}")
            if act == "fail_dispatch":
                cnt = int(ev.get("count", 1))
                if cnt < 0 or self._dispatch_failures < 0:
                    self._dispatch_failures = -1
                else:
                    self._dispatch_failures += cnt
                continue
            parsed = {"action": act, "fired": False,
                      "link": ev.get("link"),
                      "code": int(ev.get("code", 70))}
            if act in TRAFFIC_ACTIONS:
                # traffic plans carry a frame budget and a per-event
                # seed derived from the plan seed (same plan -> same
                # attack bytes; the generators below are deterministic)
                parsed["frames"] = int(ev.get("frames", 256))
                parsed["seed"] = int(ev.get("seed",
                                            rng.randint(0, 1 << 30)))
            elif act in SNAPSHOT_ACTIONS:
                # snapshot/replay drills carry a seed too (the corrupt
                # byte position, the divergence perturbation) so the
                # same plan reproduces the same fault bit-for-bit
                parsed["seed"] = int(ev.get("seed",
                                            rng.randint(0, 1 << 30)))
            for key in ("at_iter", "at_rx"):
                if key in ev:
                    v = ev[key]
                    if isinstance(v, (list, tuple)):
                        lo, hi = int(v[0]), int(v[1])
                        parsed[key] = rng.randint(lo, hi)
                    else:
                        parsed[key] = int(v)
            if "at_iter" not in parsed and "at_rx" not in parsed:
                parsed["at_iter"] = 0          # fire immediately
            self.events.append(parsed)

    def poll(self, iters: int, rx: int) -> list[dict]:
        """Events due at (iteration count, cumulative frags consumed);
        each is returned exactly once."""
        due = []
        for ev in self.events:
            if ev["fired"]:
                continue
            hit = ("at_iter" in ev and iters >= ev["at_iter"]) or \
                  ("at_rx" in ev and rx >= ev["at_rx"])
            if hit:
                ev["fired"] = True
                due.append(ev)
        return due

    def take_dispatch_failure(self) -> bool:
        """True if the next device dispatch should fail (consumes one
        budgeted failure; unbounded when the plan says count=-1)."""
        if self._dispatch_failures < 0:
            return True
        if self._dispatch_failures > 0:
            self._dispatch_failures -= 1
            return True
        return False


class ChaosDeviceError(RuntimeError):
    """Injected device-dispatch failure (distinguishable in logs from a
    real device error, handled identically by the fallback path)."""


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


def crds_spam_datagrams(n_peers: int, per_peer: int = 2,
                        seed: int = 0) -> list[bytes]:
    """Gossip CRDS push spam: VALIDLY SIGNED NodeInstance values from
    `n_peers` throwaway origins, encoded as real push containers — the
    Sybil flood: every signature verifies, every origin is unstaked,
    so only the peer table bound + stake-weighted shedding stop it."""
    from ..flamenco import gossip_wire as gw
    from ..gossip.crds import CrdsValue, KIND_NODE_INSTANCE
    from . import ed25519_ref as ref
    out = []
    rng = random.Random(seed)
    for p in range(n_peers):
        kseed = hashlib.sha256(b"crds-spam-%d-%d" % (seed, p)).digest()
        _, _, pub = ref.keypair(kseed)
        vals = []
        for j in range(per_peer):
            # NodeInstance payload (56B fixed on the wire): pubkey +
            # wallclock + token + instance id (gossip_wire
            # _payload_size/V_NODE_INSTANCE)
            wallclock = 1_000_000 + p * 1000 + j
            data = pub + wallclock.to_bytes(8, "little") \
                + rng.getrandbits(64).to_bytes(8, "little") \
                + rng.getrandbits(64).to_bytes(8, "little")
            v = CrdsValue(pub, KIND_NODE_INSTANCE, 0, wallclock, data)
            sig = ref.sign(kseed, v.signable())
            vals.append(CrdsValue(pub, KIND_NODE_INSTANCE, 0,
                                  wallclock, data, sig))
        out.append(gw.encode_container(
            gw.MSG_PUSH, pub, [v.to_wire() for v in vals]))
    return out


def malformed_quic_datagrams(n: int, seed: int = 0,
                             size: int = 512) -> list[bytes]:
    """Garbage datagrams wearing a QUIC long header (version +
    Initial-ish type bits, then noise): cheap to generate at line
    rate, must die in the QUIC parser as bad_pkts, never a crash,
    never a txn."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        body = bytes(rng.getrandbits(8) for _ in range(size - 5))
        out.append(bytes([0xC0 | (i & 0x3F)])
                   + b"\x00\x00\x00\x01" + body)
    return out


def attack_frames(action: str, frames: int, seed: int = 0) -> list[bytes]:
    """`frames` hostile payloads for a transaction, QUIC or CRDS flood,
    replayed from a pool of at most 8 distinct ones."""
    if action not in TRAFFIC_ACTIONS:
        raise ValueError(f"unknown traffic action {action!r}")
    if frames <= 0:
        return []
    if action == "flood_malformed_quic":
        pool = malformed_quic_datagrams(min(frames, _POOL), seed=seed)
    elif action == "flood_crds_spam":
        pool = crds_spam_datagrams(min(frames, _POOL), seed=seed)
    else:
        pool = _txn_pool(action, min(frames, _POOL), seed)
    return [pool[i % len(pool)] for i in range(frames)]
