"""Keyguard: role-based authorization of signing requests (copy of the
JAX package's keyguard/keyguard.py).

The sign tile is the ONLY process holding the identity key; every other
tile requests signatures over dedicated rings, and the keyguard decides
per (role, payload shape) whether the request may be signed — so a
compromised networking tile cannot exfiltrate signatures over payloads
outside its role (ref: src/disco/keyguard/fd_keyguard.h:1-30 roles;
src/disco/keyguard/fd_keyguard_authorize.c — the role switch and the
per-payload-type shape checks mirrored here).

Payload identification is structural (shape heuristics over the bytes),
then each role admits only its own payload types:

  LEADER  32-byte merkle roots (shred signing; the reference notes the
          shred/ping ambiguity and allows it, authorize.c is_shred_ping)
  GOSSIP  ping/pong tokens, prune messages (must start with our own
          pubkey, authorize.c:90), CRDS values
  REPAIR  ping/pong + repair requests (u32 discriminant 8..11 followed
          by OUR pubkey, authorize.c:94-113)
  SEND    vote transaction messages (structurally a txn message)
"""
from __future__ import annotations

from ..protocol.txn import parse_message_shape

SIGN_TYPE_ED25519 = 0
SIGN_TYPE_SHA256_ED25519 = 1          # sign(sha256(payload)); pong path

ROLE_SEND = 0
ROLE_GOSSIP = 1
ROLE_LEADER = 2
ROLE_REPAIR = 3
ROLE_NAMES = {ROLE_SEND: "send", ROLE_GOSSIP: "gossip",
              ROLE_LEADER: "leader", ROLE_REPAIR: "repair"}

PAYLOAD_TXN = 1 << 0
PAYLOAD_SHRED = 1 << 1
PAYLOAD_GOSSIP = 1 << 2
PAYLOAD_PRUNE = 1 << 3
PAYLOAD_REPAIR = 1 << 4
PAYLOAD_PING = 1 << 5
PAYLOAD_PONG = 1 << 6

SIGN_REQ_MTU = 1280
PING_TOKEN_PREFIX = b"SOLANA_PING_PONG"

# repair protocol discriminants (window_index..ancestor_hashes span)
_REPAIR_DISC_MIN, _REPAIR_DISC_MAX = 8, 11


def payload_match(identity_pubkey: bytes, data: bytes,
                  sign_type: int) -> int:
    """Structural identification mask (ref: fd_keyguard_match.c role —
    re-derived shapes, not a port)."""
    mask = 0
    sz = len(data)
    if sz == 32:
        if sign_type == SIGN_TYPE_ED25519:
            mask |= PAYLOAD_SHRED               # a bare merkle root
            if data[:16] == PING_TOKEN_PREFIX:
                mask |= PAYLOAD_PING
    if sz == 48 and sign_type == SIGN_TYPE_SHA256_ED25519 \
            and data[:16] == PING_TOKEN_PREFIX:
        mask |= PAYLOAD_PONG
    if sign_type == SIGN_TYPE_ED25519:
        if sz >= 40 and data[:32] == identity_pubkey:
            mask |= PAYLOAD_PRUNE               # prune leads with our key
        if sz >= 80 and _REPAIR_DISC_MIN <= int.from_bytes(
                data[:4], "little") <= _REPAIR_DISC_MAX \
                and data[4:36] == identity_pubkey:
            mask |= PAYLOAD_REPAIR
        if parse_message_shape(data):
            mask |= PAYLOAD_TXN
        if sz >= 64 and not (mask & (PAYLOAD_TXN | PAYLOAD_REPAIR
                                     | PAYLOAD_PRUNE)):
            mask |= PAYLOAD_GOSSIP              # CRDS value fallback
    return mask


def authorize(identity_pubkey: bytes, data: bytes, role: int,
              sign_type: int) -> bool:
    """May `role` sign `data`? (ref: fd_keyguard_payload_authorize)"""
    if len(data) > SIGN_REQ_MTU:
        return False
    mask = payload_match(identity_pubkey, data, sign_type)
    if mask == 0:
        return False
    if role == ROLE_LEADER:
        # shreds only (ping ambiguity tolerated, ref authorize.c
        # is_shred_ping — both are 32-byte ed25519 payloads)
        return bool(mask & PAYLOAD_SHRED)
    if role == ROLE_GOSSIP:
        return bool(mask & (PAYLOAD_PING | PAYLOAD_PONG | PAYLOAD_PRUNE
                            | PAYLOAD_GOSSIP))
    if role == ROLE_REPAIR:
        return bool(mask & (PAYLOAD_PING | PAYLOAD_PONG | PAYLOAD_REPAIR))
    if role == ROLE_SEND:
        return bool(mask & PAYLOAD_TXN)
    return False
