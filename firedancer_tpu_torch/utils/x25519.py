"""X25519 Diffie-Hellman (RFC 7748): host-side key agreement (copy of
the JAX package's utils/x25519.py, the same bytes for the same inputs).

The reference ships X25519 alongside ed25519 in ballet
(src/ballet/ed25519/fd_x25519.c), where it serves the TLS 1.3 handshake
(src/waltz/tls/). Same role here: the key agreement behind
waltz/tls.py's ECDHE. A handshake per connection is a control-plane
rate, so a host Montgomery ladder is the right tool; the card's kernels
stay on the verify path.

Python bigints are not constant-time; acceptable for the host paths, as
utils/ed25519_ref.py says.
"""

P = (1 << 255) - 19
A24 = 121665  # (486662 - 2) / 4


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("x25519 scalar must be 32 bytes")
    e = bytearray(k)
    e[0] &= 248
    e[31] &= 127
    e[31] |= 64
    return int.from_bytes(bytes(e), "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("x25519 u-coordinate must be 32 bytes")
    # RFC 7748 §5: mask the MSB of the final byte
    v = bytearray(u)
    v[31] &= 127
    return int.from_bytes(bytes(v), "little")


def scalarmult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 X25519(k, u) via the Montgomery ladder."""
    kn = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2 = 1, 0
    x3, z3 = x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (kn >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


BASE_U = (9).to_bytes(32, "little")


def pubkey(priv: bytes) -> bytes:
    return scalarmult(priv, BASE_U)


def shared(priv: bytes, peer_pub: bytes) -> bytes:
    """DH shared secret; raises on the all-zero output (small-order
    peer point, RFC 7748 §6.1 MUST-check)."""
    s = scalarmult(priv, peer_pub)
    if s == bytes(32):
        raise ValueError("x25519: small-order peer point")
    return s
