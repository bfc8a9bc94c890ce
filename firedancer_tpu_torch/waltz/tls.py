"""Minimal TLS 1.3 (RFC 8446) for the QUIC handshake (copy of the JAX
package's waltz/tls.py: the same messages, secrets and certificate bytes
for the same inputs).

The reference implements its own TLS 1.3 subset for exactly this job
(src/waltz/tls/fd_tls.c: server-only and QUIC-only in spirit, an X25519
key share, an Ed25519 CertificateVerify, AES-128-GCM), with a mock X.509
generator in ballet. This module has the same scope:

  * one cipher suite TLS_AES_128_GCM_SHA256 (0x1301)
  * one group x25519 (0x001d), one signature algorithm ed25519 (0x0807)
  * server auth only (no client certs), no session resumption or 0-RTT,
    no HelloRetryRequest (a client offering another group is closed)
  * a self-signed Ed25519 X.509 built by a real DER encoder (it parses
    under `cryptography.x509`)

The key schedule (§7.1), transcript hashing, Finished MACs and the
CertificateVerify context follow the RFC.

Flow (QUIC encryption levels, RFC 9001 §4.1):
  client               server
  Initial:  ClientHello --->
            <--- Initial: ServerHello
            <--- Handshake: EncryptedExtensions, Certificate,
                            CertificateVerify, Finished
  Handshake: Finished --->
  (both sides now hold the 1-RTT application secrets)

State machines expose `emit` as a list of (level, handshake_bytes) and
publish traffic secrets the moment they become available, so the QUIC
layer can install packet-protection keys per level.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import struct

from ..utils import ed25519_ref, x25519

# encryption levels (shared with waltz/quic.py)
EL_INITIAL = 0
EL_HANDSHAKE = 1
EL_APP = 2

HASH_LEN = 32  # SHA-256

CIPHER_AES128GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_ED25519 = 0x0807

# handshake message types
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20
HT_NEW_SESSION_TICKET = 4

# extensions
EXT_SERVER_NAME = 0
EXT_SUPPORTED_GROUPS = 10
EXT_SIGNATURE_ALGORITHMS = 13
EXT_ALPN = 16
EXT_SUPPORTED_VERSIONS = 43
EXT_KEY_SHARE = 51
EXT_QUIC_TRANSPORT_PARAMS = 0x39

TLS13 = 0x0304
LEGACY_VERSION = 0x0303

ALPN_TPU = b"solana-tpu"


class TlsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# HKDF / key schedule (RFC 8446 §7.1)
# ---------------------------------------------------------------------------

def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac_mod.new(salt, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac_mod.new(prk, t + info + bytes([i]),
                         hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: bytes, context: bytes,
                      length: int) -> bytes:
    full = b"tls13 " + label
    info = (struct.pack(">H", length) + bytes([len(full)]) + full
            + bytes([len(context)]) + context)
    return hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: bytes,
                  transcript: bytes) -> bytes:
    return hkdf_expand_label(secret, label,
                             hashlib.sha256(transcript).digest(),
                             HASH_LEN)


class Schedule:
    """The TLS 1.3 key schedule, advanced as transcript milestones
    arrive. Secrets are exposed as attributes; `None` until derived."""

    def __init__(self):
        zeros = bytes(HASH_LEN)
        self.early = hkdf_extract(bytes(HASH_LEN), zeros)
        self.hs: bytes | None = None
        self.master: bytes | None = None
        self.c_hs: bytes | None = None
        self.s_hs: bytes | None = None
        self.c_ap: bytes | None = None
        self.s_ap: bytes | None = None

    def on_shared(self, shared: bytes, transcript_ch_sh: bytes):
        derived = derive_secret(self.early, b"derived", b"")
        self.hs = hkdf_extract(derived, shared)
        self.c_hs = derive_secret(self.hs, b"c hs traffic",
                                  transcript_ch_sh)
        self.s_hs = derive_secret(self.hs, b"s hs traffic",
                                  transcript_ch_sh)

    def on_server_finished(self, transcript_ch_sfin: bytes):
        derived = derive_secret(self.hs, b"derived", b"")
        self.master = hkdf_extract(derived, bytes(HASH_LEN))
        self.c_ap = derive_secret(self.master, b"c ap traffic",
                                  transcript_ch_sfin)
        self.s_ap = derive_secret(self.master, b"s ap traffic",
                                  transcript_ch_sfin)


def finished_mac(base_secret: bytes, transcript: bytes) -> bytes:
    key = hkdf_expand_label(base_secret, b"finished", b"", HASH_LEN)
    return hmac_mod.new(key, hashlib.sha256(transcript).digest(),
                        hashlib.sha256).digest()


# ---------------------------------------------------------------------------
# minimal DER + self-signed Ed25519 X.509
# ---------------------------------------------------------------------------

OID_ED25519 = bytes.fromhex("06032b6570")          # 1.3.101.112
OID_CN = bytes.fromhex("0603550403")               # 2.5.4.3


def _der(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + content


def _der_seq(*parts: bytes) -> bytes:
    return _der(0x30, b"".join(parts))


def make_cert(seed: bytes) -> bytes:
    """Self-signed Ed25519 X.509v3, CN=fdtpu. Real DER (parses under
    standard tooling), fixed validity — the reference's 'x509 mock'
    role with honest encoding."""
    _, _, pub = ed25519_ref.keypair(seed)
    name = _der_seq(_der(0x31, _der_seq(
        OID_CN, _der(0x0C, b"fdtpu"))))
    validity = _der_seq(_der(0x17, b"260101000000Z"),
                        _der(0x17, b"360101000000Z"))
    spki = _der_seq(_der_seq(OID_ED25519),
                    _der(0x03, b"\x00" + pub))
    alg = _der_seq(OID_ED25519)
    tbs = _der_seq(
        _der(0xA0, _der(0x02, b"\x02")),       # [0] version v3
        _der(0x02, b"\x01"),                   # serial
        alg, name, validity, name, spki)
    sig = ed25519_ref.sign(seed, tbs)
    return _der_seq(tbs, alg, _der(0x03, b"\x00" + sig))


def cert_pubkey(cert: bytes) -> bytes:
    """Extract the Ed25519 SPKI public key: the AlgorithmIdentifier
    SEQUENCE (containing only the ed25519 OID) followed by a 33-byte
    BIT STRING (unused-bits byte + 32-byte key)."""
    pat = b"\x30\x05" + OID_ED25519 + b"\x03\x21\x00"
    i = cert.find(pat)
    if i < 0:
        raise TlsError("no ed25519 SPKI in certificate")
    return cert[i + len(pat):i + len(pat) + 32]


CV_CONTEXT_SERVER = b" " * 64 + b"TLS 1.3, server CertificateVerify" \
    + b"\x00"


def cert_verify_payload(transcript: bytes) -> bytes:
    return CV_CONTEXT_SERVER + hashlib.sha256(transcript).digest()


# ---------------------------------------------------------------------------
# handshake message codec
# ---------------------------------------------------------------------------

def _msg(ht: int, body: bytes) -> bytes:
    return bytes([ht]) + len(body).to_bytes(3, "big") + body


def _ext(et: int, body: bytes) -> bytes:
    return struct.pack(">HH", et, len(body)) + body


def _parse_exts(b: bytes) -> dict[int, bytes]:
    out = {}
    off = 0
    while off < len(b):
        et, ln = struct.unpack_from(">HH", b, off)
        out[et] = b[off + 4:off + 4 + ln]
        off += 4 + ln
    return out


def build_client_hello(random32: bytes, x_pub: bytes,
                       quic_tp: bytes) -> bytes:
    exts = b"".join([
        _ext(EXT_SUPPORTED_VERSIONS, bytes([2]) +
             struct.pack(">H", TLS13)),
        _ext(EXT_SUPPORTED_GROUPS,
             struct.pack(">HH", 2, GROUP_X25519)),
        _ext(EXT_SIGNATURE_ALGORITHMS,
             struct.pack(">HH", 2, SIG_ED25519)),
        _ext(EXT_KEY_SHARE, struct.pack(
            ">HHH", 4 + len(x_pub), GROUP_X25519, len(x_pub)) + x_pub),
        _ext(EXT_ALPN, struct.pack(">HB", len(ALPN_TPU) + 1,
                                   len(ALPN_TPU)) + ALPN_TPU),
        _ext(EXT_QUIC_TRANSPORT_PARAMS, quic_tp),
    ])
    body = (struct.pack(">H", LEGACY_VERSION) + random32
            + bytes([0])                                  # session id
            + struct.pack(">HH", 2, CIPHER_AES128GCM_SHA256)
            + bytes([1, 0])                               # compression
            + struct.pack(">H", len(exts)) + exts)
    return _msg(HT_CLIENT_HELLO, body)


def parse_client_hello(body: bytes) -> dict:
    off = 2
    random32 = body[off:off + 32]
    off += 32
    sid_len = body[off]
    off += 1 + sid_len
    cs_len, = struct.unpack_from(">H", body, off)
    suites = [struct.unpack_from(">H", body, off + 2 + i)[0]
              for i in range(0, cs_len, 2)]
    off += 2 + cs_len
    comp_len = body[off]
    off += 1 + comp_len
    ext_len, = struct.unpack_from(">H", body, off)
    exts = _parse_exts(body[off + 2:off + 2 + ext_len])
    ks = exts.get(EXT_KEY_SHARE, b"")
    x_pub = None
    if len(ks) >= 2:
        koff = 2
        while koff + 4 <= len(ks):
            grp, kl = struct.unpack_from(">HH", ks, koff)
            if grp == GROUP_X25519:
                x_pub = ks[koff + 4:koff + 4 + kl]
            koff += 4 + kl
    vers = exts.get(EXT_SUPPORTED_VERSIONS, b"")
    offers13 = TLS13 in [struct.unpack_from(">H", vers, 1 + i)[0]
                         for i in range(0, vers[0] if vers else 0, 2)]
    alpns = []
    ab = exts.get(EXT_ALPN)
    if ab and len(ab) >= 2:
        aoff = 2
        while aoff < len(ab):
            n = ab[aoff]
            alpns.append(ab[aoff + 1:aoff + 1 + n])
            aoff += 1 + n
    return {"random": random32, "suites": suites, "x_pub": x_pub,
            "tls13": offers13, "alpns": alpns,
            "quic_tp": exts.get(EXT_QUIC_TRANSPORT_PARAMS)}


def build_server_hello(random32: bytes, x_pub: bytes) -> bytes:
    exts = b"".join([
        _ext(EXT_SUPPORTED_VERSIONS, struct.pack(">H", TLS13)),
        _ext(EXT_KEY_SHARE, struct.pack(
            ">HH", GROUP_X25519, len(x_pub)) + x_pub),
    ])
    body = (struct.pack(">H", LEGACY_VERSION) + random32
            + bytes([0])
            + struct.pack(">H", CIPHER_AES128GCM_SHA256)
            + bytes([0])
            + struct.pack(">H", len(exts)) + exts)
    return _msg(HT_SERVER_HELLO, body)


def parse_server_hello(body: bytes) -> dict:
    off = 2
    random32 = body[off:off + 32]
    off += 32
    sid_len = body[off]
    off += 1 + sid_len
    suite, = struct.unpack_from(">H", body, off)
    off += 3                                   # suite + compression
    ext_len, = struct.unpack_from(">H", body, off)
    exts = _parse_exts(body[off + 2:off + 2 + ext_len])
    ks = exts.get(EXT_KEY_SHARE, b"")
    x_pub = None
    if len(ks) >= 4:
        grp, kl = struct.unpack_from(">HH", ks, 0)
        if grp == GROUP_X25519:
            x_pub = ks[4:4 + kl]
    return {"random": random32, "suite": suite, "x_pub": x_pub}


def build_certificate(cert: bytes) -> bytes:
    entry = len(cert).to_bytes(3, "big") + cert + struct.pack(">H", 0)
    body = bytes([0]) + len(entry).to_bytes(3, "big") + entry
    return _msg(HT_CERTIFICATE, body)


def parse_certificate(body: bytes) -> bytes:
    ctx_len = body[0]
    off = 1 + ctx_len + 3                      # skip list length
    cert_len = int.from_bytes(body[off:off + 3], "big")
    return body[off + 3:off + 3 + cert_len]


def iter_messages(buf: bytes):
    """Yield (type, body, raw) for complete messages; returns leftover
    offset."""
    off = 0
    while off + 4 <= len(buf):
        ht = buf[off]
        ln = int.from_bytes(buf[off + 1:off + 4], "big")
        if off + 4 + ln > len(buf):
            break
        yield ht, buf[off + 4:off + 4 + ln], buf[off:off + 4 + ln]
        off += 4 + ln
    return


def _complete_len(buf: bytes) -> int:
    """Bytes of `buf` forming complete handshake messages."""
    off = 0
    while off + 4 <= len(buf):
        ln = int.from_bytes(buf[off + 1:off + 4], "big")
        if off + 4 + ln > len(buf):
            break
        off += 4 + ln
    return off


# ---------------------------------------------------------------------------
# state machines
# ---------------------------------------------------------------------------

class _Endpoint:
    def __init__(self):
        self.sched = Schedule()
        self.transcript = b""
        self.emit: list[tuple[int, bytes]] = []   # (level, bytes)
        self.buf = {EL_INITIAL: b"", EL_HANDSHAKE: b"", EL_APP: b""}
        self.complete = False
        self.alert: str | None = None

    def _feed(self, level: int, data: bytes):
        self.buf[level] += data
        n = _complete_len(self.buf[level])
        ready = self.buf[level][:n]
        self.buf[level] = self.buf[level][n:]
        for ht, body, raw in iter_messages(ready):
            self._on_msg(level, ht, body, raw)

    def on_crypto(self, level: int, data: bytes):
        try:
            self._feed(level, data)
        except TlsError:
            raise
        except (IndexError, struct.error, ValueError) as e:
            # ValueError covers hostile key shares (x25519 length /
            # small-order rejection) — anything non-protocol becomes a
            # typed TlsError so transports can fail the conn, not crash
            raise TlsError(f"malformed handshake: {e}") from None


class TlsServer(_Endpoint):
    """Server half. Feed CRYPTO data via on_crypto; read `emit` for
    outbound CRYPTO data per level; traffic secrets appear on `sched`
    as the handshake advances; `complete` after client Finished."""

    def __init__(self, identity_seed: bytes, quic_tp: bytes = b"",
                 cert: bytes | None = None):
        super().__init__()
        self.seed = identity_seed
        self.quic_tp = quic_tp
        self.xpriv = os.urandom(32)
        self.cert = cert if cert is not None else make_cert(identity_seed)
        self.peer_quic_tp: bytes | None = None
        self.alpn_ok = False

    def _on_msg(self, level: int, ht: int, body: bytes, raw: bytes):
        if ht == HT_CLIENT_HELLO and level == EL_INITIAL \
                and self.sched.hs is None:
            ch = parse_client_hello(body)
            if not ch["tls13"] \
                    or CIPHER_AES128GCM_SHA256 not in ch["suites"] \
                    or ch["x_pub"] is None:
                self.alert = "no common cipher/group/version"
                raise TlsError(self.alert)
            if ALPN_TPU not in ch["alpns"]:
                self.alert = "no_application_protocol"
                raise TlsError(self.alert)
            self.alpn_ok = True
            self.peer_quic_tp = ch["quic_tp"]
            self.transcript = raw
            sh = build_server_hello(os.urandom(32),
                                    x25519.pubkey(self.xpriv))
            self.transcript += sh
            shared = x25519.shared(self.xpriv, ch["x_pub"])
            self.sched.on_shared(shared, self.transcript)
            self.emit.append((EL_INITIAL, sh))
            # server flight at the handshake level
            flight = _msg(HT_ENCRYPTED_EXTENSIONS, struct.pack(
                ">H", len(self.quic_tp) + 4)
                + _ext(EXT_QUIC_TRANSPORT_PARAMS, self.quic_tp))
            flight += build_certificate(self.cert)
            self.transcript += flight
            sig = ed25519_ref.sign(
                self.seed, cert_verify_payload(self.transcript))
            cv = _msg(HT_CERTIFICATE_VERIFY,
                      struct.pack(">HH", SIG_ED25519, len(sig)) + sig)
            self.transcript += cv
            fin = _msg(HT_FINISHED,
                       finished_mac(self.sched.s_hs, self.transcript))
            self.transcript += fin
            self.sched.on_server_finished(self.transcript)
            self.emit.append((EL_HANDSHAKE, flight + cv + fin))
        elif ht == HT_FINISHED and level == EL_HANDSHAKE \
                and not self.complete:
            # client Finished covers transcript through server Finished
            expect = finished_mac(self.sched.c_hs, self.transcript)
            if not hmac_mod.compare_digest(body, expect):
                self.alert = "bad client Finished"
                raise TlsError(self.alert)
            self.transcript += raw
            self.complete = True
        else:
            raise TlsError(f"unexpected message {ht} at level {level}")


class TlsClient(_Endpoint):
    """Client half. `start()` emits the ClientHello; server identity
    (SPKI pubkey) lands in `server_pub` after CertificateVerify."""

    def __init__(self, quic_tp: bytes = b"",
                 expect_pub: bytes | None = None):
        super().__init__()
        self.quic_tp = quic_tp
        self.expect_pub = expect_pub
        self.xpriv = os.urandom(32)
        self.server_pub: bytes | None = None
        self.peer_quic_tp: bytes | None = None
        self._cv_transcript: bytes | None = None

    def start(self):
        ch = build_client_hello(os.urandom(32),
                                x25519.pubkey(self.xpriv),
                                self.quic_tp)
        self.transcript = ch
        self.emit.append((EL_INITIAL, ch))

    def _on_msg(self, level: int, ht: int, body: bytes, raw: bytes):
        if ht == HT_SERVER_HELLO and level == EL_INITIAL \
                and self.sched.hs is None:
            sh = parse_server_hello(body)
            if sh["suite"] != CIPHER_AES128GCM_SHA256 \
                    or sh["x_pub"] is None:
                self.alert = "bad ServerHello"
                raise TlsError(self.alert)
            self.transcript += raw
            shared = x25519.shared(self.xpriv, sh["x_pub"])
            self.sched.on_shared(shared, self.transcript)
        elif ht == HT_ENCRYPTED_EXTENSIONS and level == EL_HANDSHAKE:
            exts = _parse_exts(body[2:])
            self.peer_quic_tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
            self.transcript += raw
        elif ht == HT_CERTIFICATE and level == EL_HANDSHAKE:
            cert = parse_certificate(body)
            self.server_pub = cert_pubkey(cert)
            if self.expect_pub is not None \
                    and self.server_pub != self.expect_pub:
                self.alert = "server identity mismatch"
                raise TlsError(self.alert)
            self.transcript += raw
        elif ht == HT_CERTIFICATE_VERIFY and level == EL_HANDSHAKE:
            alg, slen = struct.unpack_from(">HH", body, 0)
            sig = body[4:4 + slen]
            if alg != SIG_ED25519 or self.server_pub is None:
                self.alert = "bad CertificateVerify"
                raise TlsError(self.alert)
            if not ed25519_ref.verify(
                    sig, self.server_pub,
                    cert_verify_payload(self.transcript)):
                self.alert = "CertificateVerify signature invalid"
                raise TlsError(self.alert)
            self.transcript += raw
        elif ht == HT_FINISHED and level == EL_HANDSHAKE \
                and not self.complete:
            expect = finished_mac(self.sched.s_hs, self.transcript)
            if not hmac_mod.compare_digest(body, expect):
                self.alert = "bad server Finished"
                raise TlsError(self.alert)
            self.transcript += raw
            self.sched.on_server_finished(self.transcript)
            fin = _msg(HT_FINISHED,
                       finished_mac(self.sched.c_hs, self.transcript))
            self.emit.append((EL_HANDSHAKE, fin))
            self.complete = True
        elif ht == HT_NEW_SESSION_TICKET:
            pass                               # ignored (no resumption)
        else:
            raise TlsError(f"unexpected message {ht} at level {level}")
