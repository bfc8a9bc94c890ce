"""keyguard: identity-key custody + role-authorized signing (copy of the
JAX package's keyguard/, without keyswitch.py, the live identity
hot-swap region, which waits for ROADMAP.md queue A item 13;
ref: src/disco/keyguard/, src/disco/sign/fd_sign_tile.c)."""
from .keyguard import (  # noqa: F401
    ROLE_GOSSIP, ROLE_LEADER, ROLE_REPAIR, ROLE_SEND,
    SIGN_TYPE_ED25519, SIGN_TYPE_SHA256_ED25519, authorize, payload_match,
)
from .tile import KeyguardClient, SignHalted, SignTile  # noqa: F401
