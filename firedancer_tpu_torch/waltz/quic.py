"""Minimal QUIC (RFC 9000/9001 subset): the TPU transaction ingest
transport (copy of the JAX package's waltz/quic.py: the same datagrams,
metrics and errors for the same inputs).

The reference's production txn ingest is QUIC (ref: src/waltz/quic/
fd_quic.h:11-60, fd_quic.c; tile src/disco/quic/fd_quic_tile.c:234,303
`fd_tpu_reasm_publish_fast`: one transaction per unidirectional
stream). This module implements the wire subset that carries that
traffic between the port's endpoints:

  * varint encoding (RFC 9000 §16)
  * long and short packet headers, packet-number encode and decode
    (§17, A.2/A.3)
  * packet protection: initial_salt -> HKDF-SHA256 extract and
    expand-label -> AES-128-GCM payload AEAD + AES-ECB header
    protection, as RFC 9001 §5 (the AES from the `cryptography`
    package)
  * frames: PADDING PING ACK CRYPTO STREAM (all forms) MAX_* (ignored)
    HANDSHAKE_DONE CONNECTION_CLOSE

The handshake is TLS 1.3 (waltz/tls.py: x25519, an ed25519
CertificateVerify, AES-128-GCM, the profile of the reference's fd_tls):
the ClientHello rides the Initial level, the server flight (SH, EE,
Certificate, CertificateVerify, Finished) spans Initial and Handshake
packets, the client Finished returns at the Handshake level, and the
1-RTT packet keys are the TLS application traffic secrets run through
the RFC 9001 §5.1 labels. Handshake packets use their own packet-number
space (RFC 9000 §12.3).

Stream discipline (the reference's TPU contract): each client-initiated
UNIDIRECTIONAL stream carries exactly one transaction; FIN completes
it; the server reassembles out-of-order STREAM frames and hands the
payload to the tile (fd_tpu_reasm semantics).

Where the copy differs from the reference: the module imports without
the `cryptography` package, and then `Keys`, `QuicServer` and
`QuicClient` raise ModuleNotFoundError naming it (the reference fails at
the import).
"""
from __future__ import annotations

import os
import struct

try:
    from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                        modes)
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:        # require_cryptography names it at first use
    AESGCM = None

from . import tls as fdtls

# RFC 9001 §5.2 (QUIC v1)
INITIAL_SALT = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")
VERSION = 1

# packet types (long header, v1)
PT_INITIAL = 0
PT_HANDSHAKE = 2

FRAME_PADDING = 0x00
FRAME_PING = 0x01
FRAME_ACK = 0x02
FRAME_CRYPTO = 0x06
FRAME_STREAM = 0x08           # ..0x0f: OFF/LEN/FIN bits
FRAME_MAX_DATA = 0x10
FRAME_MAX_STREAM_DATA = 0x11
FRAME_MAX_STREAMS_UNI = 0x13
FRAME_CONNECTION_CLOSE = 0x1C
FRAME_HANDSHAKE_DONE = 0x1E

MAX_DATAGRAM = 1350


class QuicError(ValueError):
    pass


def require_cryptography():
    """Raise, naming the package, when `cryptography` (the AES of packet
    protection) does not import."""
    if AESGCM is None:
        raise ModuleNotFoundError(
            "the QUIC door (waltz/quic.py) needs the `cryptography` "
            "package for AES-128-GCM, which is not installed",
            name="cryptography")


class _CallbackError(Exception):
    """Carrier lifting an application on_txn exception OVER the
    hostile-datagram catch in on_datagram — a bug in the consumer must
    surface, not be miscounted as a bad packet."""


# ---------------------------------------------------------------------------
# varints (RFC 9000 §16)
# ---------------------------------------------------------------------------

def enc_varint(v: int) -> bytes:
    if v < 1 << 6:
        return bytes([v])
    if v < 1 << 14:
        return struct.pack(">H", v | 0x4000)
    if v < 1 << 30:
        return struct.pack(">I", v | 0x8000_0000)
    if v < 1 << 62:
        return struct.pack(">Q", v | 0xC000_0000_0000_0000)
    raise QuicError("varint too large")


def dec_varint(b: bytes, off: int) -> tuple[int, int]:
    if off >= len(b):
        raise QuicError("truncated varint")
    pfx = b[off] >> 6
    ln = 1 << pfx
    if off + ln > len(b):
        raise QuicError("truncated varint")
    v = b[off] & 0x3F
    for i in range(1, ln):
        v = (v << 8) | b[off + i]
    return v, off + ln


# ---------------------------------------------------------------------------
# HKDF + TLS 1.3 expand-label — one implementation, in waltz/tls.py
# (RFC 9001 uses the RFC 8446 KDF with an empty context)
# ---------------------------------------------------------------------------

hkdf_extract = fdtls.hkdf_extract


def hkdf_expand_label(secret: bytes, label: bytes, length: int) -> bytes:
    return fdtls.hkdf_expand_label(secret, label, b"", length)


class Keys:
    """One direction's packet protection keys (RFC 9001 §5.1)."""

    def __init__(self, secret: bytes):
        require_cryptography()
        self.key = hkdf_expand_label(secret, b"quic key", 16)
        self.iv = hkdf_expand_label(secret, b"quic iv", 12)
        self.hp = hkdf_expand_label(secret, b"quic hp", 16)
        self.aead = AESGCM(self.key)

    def nonce(self, pn: int) -> bytes:
        return (int.from_bytes(self.iv, "big") ^ pn).to_bytes(12, "big")

    def hp_mask(self, sample: bytes) -> bytes:
        enc = Cipher(algorithms.AES(self.hp), modes.ECB()).encryptor()
        return enc.update(sample[:16])[:5]


def initial_keys(dcid: bytes) -> tuple[Keys, Keys, bytes]:
    """(client_keys, server_keys, initial_secret) per RFC 9001 §5.2."""
    initial = hkdf_extract(INITIAL_SALT, dcid)
    c = hkdf_expand_label(initial, b"client in", 32)
    s = hkdf_expand_label(initial, b"server in", 32)
    return Keys(c), Keys(s), initial


class CryptoBuf:
    """Per-encryption-level in-order reassembly of the CRYPTO stream
    (RFC 9000 §19.6: offsets, arbitrary re-fragmentation, overlapping
    duplication — retransmits may re-slice already-consumed ranges)."""

    MAX = 1 << 16

    def __init__(self):
        self.chunks: dict[int, bytes] = {}
        self.next = 0

    def add(self, offset: int, data: bytes):
        if offset + len(data) > self.MAX:
            raise QuicError("crypto stream exceeds cap")
        if offset < self.next:                 # trim consumed prefix
            data = data[self.next - offset:]
            offset = self.next
        if not data:
            return
        have = self.chunks.get(offset)
        if have is None or len(data) > len(have):
            self.chunks[offset] = data

    def drain(self) -> bytes:
        out = b""
        while True:
            c = self.chunks.pop(self.next, None)
            if c is None:
                # an overlapping chunk may start before `next` yet
                # extend past it
                for off in sorted(self.chunks):
                    if off > self.next:
                        break
                    c2 = self.chunks.pop(off)
                    if off + len(c2) > self.next:
                        c = c2[self.next - off:]
                        break
                if c is None:
                    break
            out += c
            self.next += len(c)
        return out


# ---------------------------------------------------------------------------
# packet protection (RFC 9001 §5.3/5.4)
# ---------------------------------------------------------------------------

def _encode_pn(pn: int) -> bytes:
    return struct.pack(">I", pn & 0xFFFFFFFF)[2:]     # 2-byte pn


def decode_pn(truncated: int, pn_len: int, largest: int) -> int:
    """Reconstruct the full packet number from its truncated wire form
    (RFC 9000 Appendix A.3) given the largest pn received so far."""
    pn_nbits = 8 * pn_len
    expected = largest + 1
    pn_win = 1 << pn_nbits
    pn_hwin = pn_win >> 1
    pn_mask = pn_win - 1
    candidate = (expected & ~pn_mask) | truncated
    if candidate <= expected - pn_hwin and candidate < (1 << 62) - pn_win:
        return candidate + pn_win
    if candidate > expected + pn_hwin and candidate >= pn_win:
        return candidate - pn_win
    return candidate


def seal_long(keys: Keys, ptype: int, dcid: bytes, scid: bytes,
              pn: int, payload: bytes) -> bytes:
    if len(payload) < 4:                      # see seal_short
        payload = payload + bytes(4 - len(payload))
    pn_bytes = _encode_pn(pn)
    first = 0xC0 | (ptype << 4) | (len(pn_bytes) - 1)
    hdr = bytes([first]) + struct.pack(">I", VERSION)
    hdr += bytes([len(dcid)]) + dcid + bytes([len(scid)]) + scid
    if ptype == PT_INITIAL:
        hdr += enc_varint(0)                          # token length
    length = len(pn_bytes) + len(payload) + 16
    hdr += enc_varint(length)
    pn_off = len(hdr)
    hdr += pn_bytes
    ct = keys.aead.encrypt(keys.nonce(pn), payload, hdr)
    pkt = bytearray(hdr + ct)
    sample = bytes(pkt[pn_off + 4:pn_off + 20])
    mask = keys.hp_mask(sample)
    pkt[0] ^= mask[0] & 0x0F
    for i in range(len(pn_bytes)):
        pkt[pn_off + i] ^= mask[1 + i]
    return bytes(pkt)


def seal_short(keys: Keys, dcid: bytes, pn: int, payload: bytes) -> bytes:
    # header protection samples 16 bytes starting 4 past the pn offset
    # (RFC 9001 §5.4.2): pad tiny payloads (PADDING frames) so the
    # sample always exists
    if len(payload) < 4:
        payload = payload + bytes(4 - len(payload))
    pn_bytes = _encode_pn(pn)
    first = 0x40 | (len(pn_bytes) - 1)
    hdr = bytes([first]) + dcid
    pn_off = len(hdr)
    hdr += pn_bytes
    ct = keys.aead.encrypt(keys.nonce(pn), payload, hdr)
    pkt = bytearray(hdr + ct)
    sample = bytes(pkt[pn_off + 4:pn_off + 20])
    mask = keys.hp_mask(sample)
    pkt[0] ^= mask[0] & 0x1F
    for i in range(len(pn_bytes)):
        pkt[pn_off + i] ^= mask[1 + i]
    return bytes(pkt)


def long_header_len(pkt: bytes) -> int:
    """Length of the first coalesced long-header packet WITHOUT
    decrypting (the long header through the length field is cleartext)
    — used to skip packets whose keys have been discarded (RFC 9001
    §4.9.1)."""
    off = 5
    dlen = pkt[off]
    off += 1 + dlen
    slen = pkt[off]
    off += 1 + slen
    if (pkt[0] >> 4) & 0x03 == PT_INITIAL:
        tok_len, off = dec_varint(pkt, off)
        off += tok_len
    length, off = dec_varint(pkt, off)
    end = off + length
    if end > len(pkt):
        raise QuicError("truncated packet")
    return end


def open_long(keys: Keys, pkt: bytes) -> tuple[int, bytes, bytes, bytes,
                                               int]:
    """-> (ptype, dcid, scid, payload, consumed). Raises QuicError."""
    if len(pkt) < 7 or not pkt[0] & 0x80:
        raise QuicError("not a long-header packet")
    off = 1
    ver, = struct.unpack_from(">I", pkt, off)
    off += 4
    if ver != VERSION:
        raise QuicError(f"version {ver:#x}")
    dlen = pkt[off]
    dcid = pkt[off + 1:off + 1 + dlen]
    off += 1 + dlen
    slen = pkt[off]
    scid = pkt[off + 1:off + 1 + slen]
    off += 1 + slen
    ptype = (pkt[0] >> 4) & 0x03
    if ptype == PT_INITIAL:
        tok_len, off = dec_varint(pkt, off)
        off += tok_len
    length, off = dec_varint(pkt, off)
    pn_off = off
    end = pn_off + length
    if end > len(pkt):
        raise QuicError("truncated packet")
    sample = pkt[pn_off + 4:pn_off + 20]
    mask = keys.hp_mask(sample)
    first = pkt[0] ^ (mask[0] & 0x0F)
    pn_len = (first & 0x03) + 1
    pn_bytes = bytes(pkt[pn_off + i] ^ mask[1 + i]
                     for i in range(pn_len))
    pn = int.from_bytes(pn_bytes, "big")
    hdr = bytes([first]) + pkt[1:pn_off] + pn_bytes
    ct = pkt[pn_off + pn_len:end]
    try:
        payload = keys.aead.decrypt(keys.nonce(pn), ct, hdr)
    except Exception:
        raise QuicError("AEAD open failed")
    return ptype, dcid, scid, payload, end


def open_short(keys: Keys, pkt: bytes, dcid_len: int,
               largest: int = -1) -> tuple[int, bytes]:
    if len(pkt) < 1 + dcid_len + 20 or pkt[0] & 0x80:
        raise QuicError("not a short-header packet")
    pn_off = 1 + dcid_len
    sample = pkt[pn_off + 4:pn_off + 20]
    mask = keys.hp_mask(sample)
    first = pkt[0] ^ (mask[0] & 0x1F)
    pn_len = (first & 0x03) + 1
    pn_bytes = bytes(pkt[pn_off + i] ^ mask[1 + i]
                     for i in range(pn_len))
    pn = decode_pn(int.from_bytes(pn_bytes, "big"), pn_len, largest)
    hdr = bytes([first]) + pkt[1:pn_off] + pn_bytes
    ct = pkt[pn_off + pn_len:]
    try:
        payload = keys.aead.decrypt(keys.nonce(pn), ct, hdr)
    except Exception:
        raise QuicError("AEAD open failed")
    return pn, payload


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def enc_stream_frame(stream_id: int, offset: int, data: bytes,
                     fin: bool) -> bytes:
    t = FRAME_STREAM | 0x02                   # LEN always present
    if offset:
        t |= 0x04
    if fin:
        t |= 0x01
    out = bytes([t]) + enc_varint(stream_id)
    if offset:
        out += enc_varint(offset)
    out += enc_varint(len(data)) + data
    return out


def enc_crypto_frame(offset: int, data: bytes) -> bytes:
    return (bytes([FRAME_CRYPTO]) + enc_varint(offset)
            + enc_varint(len(data)) + data)


def enc_ack_frame(largest: int) -> bytes:
    return (bytes([FRAME_ACK]) + enc_varint(largest) + enc_varint(0)
            + enc_varint(0) + enc_varint(0))


def parse_frames(payload: bytes):
    """Yield (type, dict) for every frame; unknown frames raise."""
    off = 0
    n = len(payload)
    while off < n:
        t = payload[off]
        if t == FRAME_PADDING:
            off += 1
            continue
        if t == FRAME_PING:
            off += 1
            yield FRAME_PING, {}
            continue
        if t in (FRAME_ACK, FRAME_ACK + 1):
            largest, off2 = dec_varint(payload, off + 1)
            delay, off2 = dec_varint(payload, off2)
            cnt, off2 = dec_varint(payload, off2)
            first, off2 = dec_varint(payload, off2)
            for _ in range(cnt):
                gap, off2 = dec_varint(payload, off2)
                rl, off2 = dec_varint(payload, off2)
            if t == FRAME_ACK + 1:            # ECN counts
                for _ in range(3):
                    _, off2 = dec_varint(payload, off2)
            off = off2
            yield FRAME_ACK, {"largest": largest}
            continue
        if t == FRAME_CRYPTO:
            o, off2 = dec_varint(payload, off + 1)
            ln, off2 = dec_varint(payload, off2)
            yield FRAME_CRYPTO, {"offset": o,
                                 "data": payload[off2:off2 + ln]}
            off = off2 + ln
            continue
        if FRAME_STREAM <= t <= FRAME_STREAM | 0x07:
            sid, off2 = dec_varint(payload, off + 1)
            o = 0
            if t & 0x04:
                o, off2 = dec_varint(payload, off2)
            if t & 0x02:
                ln, off2 = dec_varint(payload, off2)
            else:
                ln = n - off2
            yield FRAME_STREAM, {"stream": sid, "offset": o,
                                 "data": payload[off2:off2 + ln],
                                 "fin": bool(t & 0x01)}
            off = off2 + ln
            continue
        if t in (FRAME_MAX_DATA, FRAME_MAX_STREAM_DATA,
                 FRAME_MAX_STREAMS_UNI):
            _, off = dec_varint(payload, off + 1)
            if t == FRAME_MAX_STREAM_DATA:
                _, off = dec_varint(payload, off)
            continue
        if t == FRAME_HANDSHAKE_DONE:
            off += 1
            yield FRAME_HANDSHAKE_DONE, {}
            continue
        if t in (FRAME_CONNECTION_CLOSE, FRAME_CONNECTION_CLOSE + 1):
            code, off2 = dec_varint(payload, off + 1)
            if t == FRAME_CONNECTION_CLOSE:
                ft, off2 = dec_varint(payload, off2)
            rlen, off2 = dec_varint(payload, off2)
            yield FRAME_CONNECTION_CLOSE, {"code": code}
            off = off2 + rlen
            continue
        raise QuicError(f"unknown frame type {t:#x}")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

MAX_STREAM_BYTES = 64 * 1024          # per-stream reassembly cap


class _Stream:
    __slots__ = ("chunks", "fin_at", "delivered", "buffered")

    def __init__(self):
        self.chunks: dict[int, bytes] = {}
        self.fin_at: int | None = None
        self.delivered = False
        self.buffered = 0

    def add(self, offset: int, data: bytes, fin: bool):
        """Raises QuicError when the stream exceeds the reassembly cap
        (hostile never-FIN streams must not grow memory unboundedly)."""
        if offset + len(data) > MAX_STREAM_BYTES:
            raise QuicError("stream exceeds reassembly cap")
        if data and offset not in self.chunks:
            self.buffered += len(data)
            if self.buffered > MAX_STREAM_BYTES:
                raise QuicError("stream exceeds reassembly cap")
            self.chunks[offset] = data
        if fin:
            end = offset + len(data)
            self.fin_at = end if self.fin_at is None \
                else min(self.fin_at, end)

    def complete(self) -> bytes | None:
        if self.fin_at is None or self.delivered:
            return None
        out = bytearray()
        off = 0
        while off < self.fin_at:
            c = self.chunks.get(off)
            if c is None:
                return None                   # gap
            out += c
            off += len(c)
        self.delivered = True
        return bytes(out[:self.fin_at])


class _Conn:
    def __init__(self, scid: bytes, ckeys: Keys, skeys: Keys,
                 initial_secret: bytes, peer: tuple,
                 tls: "fdtls.TlsServer"):
        self.scid = scid                      # our CID (client's dcid)
        self.ckeys = ckeys                    # client Initial keys
        self.skeys = skeys                    # server Initial keys
        self.initial_secret = initial_secret
        self.peer = peer
        self.tls = tls
        self.cbuf = {fdtls.EL_INITIAL: CryptoBuf(),
                     fdtls.EL_HANDSHAKE: CryptoBuf()}
        self.chs: Keys | None = None          # client Handshake keys
        self.shs: Keys | None = None          # server Handshake keys
        self.c1rtt: Keys | None = None
        self.s1rtt: Keys | None = None
        self.client_cid = b""
        self.cid_latched = False    # RFC 9000 allows zero-length SCIDs
        self.streams: dict[int, _Stream] = {}
        self.tx_pn = 0                        # 1-RTT pn space
        self.tx_pn_i = 0                      # Initial pn space
        self.tx_pn_h = 0                      # Handshake pn space
        self.rx_largest = -1
        self.rx_window = 0               # bitmap of the last 64 pns
        self.done_streams = 0
        self.hs_response: bytes | None = None    # for Initial retransmit
        self.done_sent = False
        # RFC 9001 §4.9.1: Initial keys are dead once a packet protected
        # with Handshake keys is processed; forged Initials (their keys
        # derive from the public dcid) must not reach the TLS machine
        self.initial_done = False

    def pn_fresh(self, pn: int) -> bool:
        """Anti-replay window (the RFC 9001 §9.2 duty): accept each
        1-RTT pn at most once within a 64-packet sliding window; pns
        older than the window are rejected outright."""
        if pn > self.rx_largest:
            shift = pn - self.rx_largest
            self.rx_window = ((self.rx_window << shift) | 1) \
                & ((1 << 64) - 1)
            self.rx_largest = pn
            return True
        back = self.rx_largest - pn
        if back >= 64:
            return False
        bit = 1 << back
        if self.rx_window & bit:
            return False
        self.rx_window |= bit
        return True


class QuicServer:
    """Single-socket TPU-ingest server: datagram in -> txn payloads out
    (the fd_quic_tile ingest contract). `identity_seed` is the ed25519
    key behind the TLS certificate (ephemeral when omitted)."""

    def __init__(self, sock, on_txn, cid_len: int = 8,
                 max_streams: int = 4096,
                 identity_seed: bytes | None = None):
        require_cryptography()
        self.sock = sock
        self.on_txn = on_txn
        self.cid_len = cid_len
        self.max_streams = max_streams
        self.identity_seed = identity_seed or os.urandom(32)
        self._cert_cache: bytes | None = None
        self.conns: dict[bytes, _Conn] = {}
        self.metrics = {"pkts": 0, "bad_pkts": 0, "conns": 0,
                        "txns": 0, "streams": 0, "closed": 0,
                        "replayed": 0}

    def _cert(self) -> bytes:
        """The identity certificate, built once (a DER build + host
        ed25519 sign per connection would be handshake-flood bait)."""
        if self._cert_cache is None:
            self._cert_cache = fdtls.make_cert(self.identity_seed)
        return self._cert_cache

    # -- datagram ingest ----------------------------------------------------

    def on_datagram(self, data: bytes, addr) -> int:
        self.metrics["pkts"] += 1
        try:
            if data[0] & 0x80:
                return self._on_long(data, addr)
            return self._on_short(data, addr)
        except _CallbackError as e:
            raise e.__cause__ from None        # consumer bug: surface
        except (ValueError, IndexError, struct.error):
            # ValueError covers QuicError + anything a hostile
            # handshake can raise out of the TLS layer: one bad
            # datagram must never kill the ingest tile
            self.metrics["bad_pkts"] += 1
            return 0

    def _on_long(self, data: bytes, addr) -> int:
        """Handle a datagram of one or more coalesced long-header
        packets (RFC 9000 §12.2 — standard clients coalesce
        Initial(ACK) + Handshake(Finished) in one datagram)."""
        # peek dcid for key derivation (header is cleartext up to pn)
        dlen = data[5]
        dcid = data[6:6 + dlen]
        ptype_peek = (data[0] >> 4) & 0x03
        conn = self.conns.get(dcid)
        created = conn is None
        if created:
            if ptype_peek != PT_INITIAL:
                raise QuicError("first packet must be Initial")
            ck, sk, isec = initial_keys(dcid)
            if len(self.conns) >= self.max_streams:
                self.conns.pop(next(iter(self.conns)))
            conn = _Conn(dcid, ck, sk, isec, addr,
                         fdtls.TlsServer(self.identity_seed,
                                         cert=self._cert()))
            self.conns[dcid] = conn
            self.metrics["conns"] += 1
        handled = 0
        off = 0
        opened = 0
        initial_seen = False
        while off < len(data) and data[off] & 0x80:
            chunk = data[off:]
            ptype_peek = (chunk[0] >> 4) & 0x03
            if ptype_peek == PT_INITIAL:
                if conn.initial_done:          # discarded keys: skip
                    off += long_header_len(chunk)
                    continue
                keys, level = conn.ckeys, fdtls.EL_INITIAL
            elif conn.chs is not None:
                keys, level = conn.chs, fdtls.EL_HANDSHAKE
            else:
                raise QuicError("no handshake keys yet")
            try:
                ptype, _, scid, payload, consumed = open_long(keys,
                                                              chunk)
            except QuicError:
                if opened:
                    break          # trailing garbage after good pkts
                if created:        # never-authenticated conn: drop it
                    self.conns.pop(dcid, None)
                raise
            opened += 1
            off += consumed
            if ptype == PT_INITIAL:
                # Latch the return-CID on the FIRST authenticated
                # Initial only: Initial keys derive from the public
                # DCID, so an off-path forger could otherwise redirect
                # our flights with a bogus SCID pre-handshake.
                if not conn.cid_latched:
                    conn.client_cid = scid
                    conn.cid_latched = True
                initial_seen = True
            else:
                conn.initial_done = True
            fed = b""
            for ft, f in parse_frames(payload):
                if ft != FRAME_CRYPTO:
                    continue
                conn.cbuf[level].add(f["offset"], f["data"])
                fed += conn.cbuf[level].drain()
            if fed:
                try:
                    conn.tls.on_crypto(level, fed)
                except fdtls.TlsError:
                    self.conns.pop(dcid, None)
                    raise QuicError("tls failure") from None
                handled += self._pump_tls(conn, addr)
                initial_seen = False
        if not handled and initial_seen \
                and conn.hs_response is not None:
            # retransmitted Initial with no fresh CRYPTO: the client
            # lost our flight — resend it (loss tolerance, RFC 9002)
            self.sock.sendto(conn.hs_response, addr)
            handled += 1
        return handled

    def _pump_tls(self, conn: _Conn, addr) -> int:
        """Flush TLS emissions as sealed packets; install keys as the
        schedule advances. Server flight is coalesced into one
        datagram (RFC 9001 §4.1 pattern)."""
        out = b""
        while conn.tls.emit:
            lvl, hs_data = conn.tls.emit.pop(0)
            if lvl == fdtls.EL_INITIAL:
                payload = enc_ack_frame(0) + enc_crypto_frame(0, hs_data)
                out += seal_long(conn.skeys, PT_INITIAL,
                                 conn.client_cid, conn.scid,
                                 conn.tx_pn_i, payload)
                conn.tx_pn_i += 1
                # SH emitted -> handshake secrets exist
                conn.chs = Keys(conn.tls.sched.c_hs)
                conn.shs = Keys(conn.tls.sched.s_hs)
            else:
                off = 0
                while off < len(hs_data):
                    chunk = hs_data[off:off + 1100]
                    payload = enc_crypto_frame(off, chunk)
                    out += seal_long(conn.shs, PT_HANDSHAKE,
                                     conn.client_cid, conn.scid,
                                     conn.tx_pn_h, payload)
                    conn.tx_pn_h += 1
                    off += len(chunk)
                # server Finished emitted -> application secrets exist
                conn.c1rtt = Keys(conn.tls.sched.c_ap)
                conn.s1rtt = Keys(conn.tls.sched.s_ap)
        sent = 0
        if out:
            conn.hs_response = out
            self.sock.sendto(out, addr)
            sent = 1
        if conn.tls.complete and not conn.done_sent:
            done = seal_short(conn.s1rtt, conn.client_cid, conn.tx_pn,
                              bytes([FRAME_HANDSHAKE_DONE]))
            conn.tx_pn += 1
            self.sock.sendto(done, addr)
            conn.done_sent = True
            sent += 1
        return sent

    def _on_short(self, data: bytes, addr) -> int:
        dcid = data[1:1 + self.cid_len]
        conn = self.conns.get(dcid)
        if conn is None or conn.c1rtt is None:
            raise QuicError("no 1-RTT keys for connection")
        if not conn.tls.complete:
            # RFC 9001 §5.7: the server must not process 1-RTT data
            # before the client Finished authenticates the handshake
            raise QuicError("1-RTT before handshake completion")
        pn, payload = open_short(conn.c1rtt, data, self.cid_len,
                                 conn.rx_largest)
        if not conn.pn_fresh(pn):
            self.metrics["replayed"] += 1
            return 0                      # duplicate/replayed datagram
        handled = 0
        acked = False
        for ft, f in parse_frames(payload):
            if ft == FRAME_STREAM:
                st = conn.streams.get(f["stream"])
                if st is None:
                    if len(conn.streams) >= self.max_streams:
                        conn.streams.pop(next(iter(conn.streams)))
                    st = conn.streams[f["stream"]] = _Stream()
                    self.metrics["streams"] += 1
                st.add(f["offset"], f["data"], f["fin"])
                txn = st.complete()
                if txn is not None:
                    self.metrics["txns"] += 1
                    try:
                        self.on_txn(txn)
                    except Exception as e:
                        raise _CallbackError() from e
                    handled += 1
                    del conn.streams[f["stream"]]
                    conn.done_streams += 1
                if not acked:
                    ack = seal_short(conn.s1rtt, conn.client_cid,
                                     conn.tx_pn, enc_ack_frame(pn))
                    conn.tx_pn += 1
                    self.sock.sendto(ack, addr)
                    acked = True
            elif ft == FRAME_CONNECTION_CLOSE:
                self.conns.pop(dcid, None)
                self.metrics["closed"] += 1
                break
        return handled


# ---------------------------------------------------------------------------
# client (tests / bench load generation)
# ---------------------------------------------------------------------------

class QuicClient:
    def __init__(self, sock, server_addr, cid_len: int = 8,
                 expect_pub: bytes | None = None):
        require_cryptography()
        self.sock = sock
        self.addr = server_addr
        self.scid = os.urandom(cid_len)       # our CID
        self.dcid = os.urandom(cid_len)       # server's CID for us
        self.ckeys, self.skeys, self.initial_secret = \
            initial_keys(self.dcid)
        self.tls = fdtls.TlsClient(expect_pub=expect_pub)
        self.cbuf = {fdtls.EL_INITIAL: CryptoBuf(),
                     fdtls.EL_HANDSHAKE: CryptoBuf()}
        self.chs: Keys | None = None
        self.shs: Keys | None = None
        self.c1rtt: Keys | None = None
        self.s1rtt: Keys | None = None
        self.tx_pn = 0
        self.tx_pn_i = 0
        self.tx_pn_h = 0
        self.rx_largest = -1
        self.next_stream = 2                  # client-initiated uni: 2,6,..
        self.server_pub: bytes | None = None

    def handshake(self, timeout: float = 5.0, retries: int = 3):
        self.tls.start()
        _, ch = self.tls.emit.pop(0)
        hello = enc_crypto_frame(0, ch)
        hello += bytes(max(0, 1162 - len(hello)))     # Initial padding
        pkt = seal_long(self.ckeys, PT_INITIAL, self.dcid, self.scid,
                        self.tx_pn_i, hello)
        self.tx_pn_i += 1
        self.sock.settimeout(timeout)
        for _ in range(retries):
            self.sock.sendto(pkt, self.addr)
            try:
                while not self.tls.complete:
                    data, _ = self.sock.recvfrom(4096)
                    try:
                        self._on_hs_datagram(data)
                    except fdtls.TlsError:
                        raise              # authentication failure
                    except (ValueError, IndexError, struct.error):
                        continue           # stray/garbage datagram
                break
            except TimeoutError:
                continue
        if not self.tls.complete:
            raise QuicError("handshake failed")
        self.server_pub = self.tls.server_pub

    def _on_hs_datagram(self, data: bytes):
        """Parse coalesced long-header packets, feed TLS, flush the
        client Finished when it appears."""
        off = 0
        while off < len(data) and off + 1 < len(data) \
                and data[off] & 0x80:
            chunk = data[off:]
            ptype_peek = (chunk[0] >> 4) & 0x03
            if ptype_peek == PT_INITIAL:
                if self.shs is not None:
                    # Initial keys discarded (RFC 9001 §4.9.1): the
                    # keys are public-derivable, so late/forged
                    # Initials must not reach the TLS machine
                    off += long_header_len(chunk)
                    continue
                keys, level = self.skeys, fdtls.EL_INITIAL
            else:
                if self.shs is None:
                    break
                keys, level = self.shs, fdtls.EL_HANDSHAKE
            ptype, _, _, payload, consumed = open_long(keys, chunk)
            off += consumed
            fed = b""
            for ft, f in parse_frames(payload):
                if ft == FRAME_CRYPTO:
                    self.cbuf[level].add(f["offset"], f["data"])
                    fed += self.cbuf[level].drain()
            if fed:
                self.tls.on_crypto(level, fed)
            if self.tls.sched.s_hs is not None and self.shs is None:
                self.chs = Keys(self.tls.sched.c_hs)
                self.shs = Keys(self.tls.sched.s_hs)
        while self.tls.emit:
            lvl, hs_data = self.tls.emit.pop(0)
            pkt = seal_long(self.chs, PT_HANDSHAKE, self.dcid,
                            self.scid, self.tx_pn_h,
                            enc_crypto_frame(0, hs_data))
            self.tx_pn_h += 1
            self.sock.sendto(pkt, self.addr)
        if self.tls.complete and self.c1rtt is None:
            self.c1rtt = Keys(self.tls.sched.c_ap)
            self.s1rtt = Keys(self.tls.sched.s_ap)

    def send_txn(self, payload: bytes):
        """One txn = one unidirectional stream with FIN (the TPU
        contract)."""
        sid = self.next_stream
        self.next_stream += 4
        off = 0
        mss = MAX_DATAGRAM - 64
        while off < len(payload) or off == 0:
            chunk = payload[off:off + mss]
            fin = off + len(chunk) >= len(payload)
            frame = enc_stream_frame(sid, off, chunk, fin)
            pkt = seal_short(self.c1rtt, self.dcid, self.tx_pn, frame)
            self.tx_pn += 1
            self.sock.sendto(pkt, self.addr)
            off += len(chunk)
            if fin:
                break

    def recv_acks(self, max_pkts: int = 16):
        self.sock.setblocking(False)
        n = 0
        for _ in range(max_pkts):
            try:
                data, _ = self.sock.recvfrom(2048)
            except OSError:
                break
            try:
                pn, payload = open_short(self.s1rtt, data,
                                         len(self.scid),
                                         self.rx_largest)
                self.rx_largest = max(self.rx_largest, pn)
                n += sum(1 for ft, _ in parse_frames(payload)
                         if ft == FRAME_ACK)
            except QuicError:
                pass
        return n
