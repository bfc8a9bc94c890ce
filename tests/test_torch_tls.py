"""The port's TLS 1.3 (waltz/tls.py) and X25519 (utils/x25519.py) against
the JAX package's: the RFC 7748 vectors and seeded scalars on both, the
certificate byte for byte (and parsed under `cryptography.x509`), a whole
handshake under one seeded entropy stream in which every emitted message,
transcript and secret is the reference's, the same byte for byte when
delivered in fragments, and the reference's four rejection cases
(tests/test_tls.py) run on both packages in lockstep
(tests/torch_lockstep.py) under the same seeded `os.urandom`, each
raising its package's TlsError. Host code only: exact."""
import os

import pytest

import test_tls
from torch_lockstep import ROOTS, run_on, seeded_urandom as stream

from firedancer_tpu.utils import x25519 as jx
from firedancer_tpu.waltz import tls as jtls
from firedancer_tpu_torch.utils import ed25519_ref as ted
from firedancer_tpu_torch.utils import x25519 as tx
from firedancer_tpu_torch.waltz import tls as ttls

SECRETS = ("early", "hs", "master", "c_hs", "s_hs", "c_ap", "s_ap")


# -- x25519 -----------------------------------------------------------------

def test_x25519_rfc7748_vectors_and_seeded_scalars():
    for k, u, want in (
            ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
             "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
             "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
            ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
             "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
             "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")):
        assert tx.scalarmult(bytes.fromhex(k), bytes.fromhex(u)).hex() == want
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645"
                      "df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee6"
                      "6f3bb1292618b6fd1c2f8b27ff88e0eb")
    assert tx.shared(a, tx.pubkey(b)).hex() == (
        "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey)
    raw = serialization.Encoding.Raw, serialization.PublicFormat.Raw
    draw = stream(7748)
    for _ in range(12):
        k, u = draw(32), draw(32)
        assert tx.pubkey(k) == jx.pubkey(k) == \
            X25519PrivateKey.from_private_bytes(k).public_key() \
            .public_bytes(*raw)
        assert tx.scalarmult(k, u) == jx.scalarmult(k, u)
        assert tx.shared(k, tx.pubkey(u)) == jx.shared(k, jx.pubkey(u))


@pytest.mark.parametrize("bad", [bytes(32), (1).to_bytes(32, "little"),
                                 b"\x01" * 7])
def test_x25519_rejects_small_order_and_bad_lengths(bad):
    k = stream(1)(32)
    for mod in (tx, jx):
        with pytest.raises(ValueError) as e:
            mod.shared(k, bad)
        assert type(e.value) is ValueError


# -- the certificate ---------------------------------------------------------

def test_cert_equals_reference_and_parses():
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey)
    draw = stream(176)
    for _ in range(4):
        seed = draw(32)
        der = ttls.make_cert(seed)
        assert der == jtls.make_cert(seed)
        pub = ted.keypair(seed)[-1]
        cert = x509.load_der_x509_certificate(der)
        assert cert.public_key().public_bytes(
            serialization.Encoding.Raw,
            serialization.PublicFormat.Raw) == pub == ttls.cert_pubkey(der)
        Ed25519PublicKey.from_public_bytes(pub).verify(
            cert.signature, cert.tbs_certificate_bytes)


# -- the handshake -----------------------------------------------------------

def _handshake(tls, seed: int, chunk: int = 0):
    """One handshake between `tls`'s client and server; every message
    each emits, in order, and both sides' transcripts and secrets. Both
    endpoints draw from os.urandom. With `chunk`, CRYPTO data arrives
    `chunk` bytes at a time."""
    ident = stream(seed)(32)
    srv = tls.TlsServer(ident, quic_tp=b"\x05\x06")
    cli = tls.TlsClient(quic_tp=b"\x07\x08",
                        expect_pub=ted.keypair(ident)[-1])
    cli.start()
    sent = []
    while not (srv.complete and cli.complete):
        moved = False
        for a, b, who in ((cli, srv, "c"), (srv, cli, "s")):
            while a.emit:
                lvl, data = a.emit.pop(0)
                sent.append((who, lvl, data))
                step = chunk or len(data)
                for i in range(0, len(data), step):
                    b.on_crypto(lvl, data[i:i + step])
                moved = True
        assert moved, "handshake stalled"
    return {"sent": sent, "transcripts": (srv.transcript, cli.transcript),
            "xpriv": (srv.xpriv, cli.xpriv),
            "secrets": [(getattr(srv.sched, n), getattr(cli.sched, n))
                        for n in SECRETS],
            "peer_tp": (srv.peer_quic_tp, cli.peer_quic_tp),
            "server_pub": cli.server_pub, "alpn_ok": srv.alpn_ok}


@pytest.mark.parametrize("chunk", [0, 1, 7], ids=["whole", "bytes",
                                                   "sevens"])
def test_handshake_equals_reference_under_one_entropy(monkeypatch, chunk):
    monkeypatch.setattr(os, "urandom", stream(8446))
    ref = _handshake(jtls, 3, chunk=chunk)
    monkeypatch.setattr(os, "urandom", stream(8446))
    assert _handshake(ttls, 3, chunk=chunk) == ref
    assert [(w, lvl) for w, lvl, _ in ref["sent"]] == \
        [("c", 0), ("s", 0), ("s", 1), ("c", 1)]
    for s, c in ref["secrets"]:
        assert s == c and s is not None
    assert ref["peer_tp"] == (b"\x07\x08", b"\x05\x06") and ref["alpn_ok"]


# -- the reference's rejection cases, in lockstep ---------------------------

NAMES = {"tls": "waltz.tls", "x25519": "utils.x25519",
         "ed25519_ref": "utils.ed25519_ref"}


@pytest.mark.parametrize("case", [
    "test_client_rejects_wrong_identity",
    "test_client_rejects_forged_certificate_verify",
    "test_server_rejects_bad_client_finished",
    "test_server_rejects_no_common_cipher"])
def test_rejection_cases_match_reference(monkeypatch, case):
    fn = getattr(test_tls, case)
    recs = []
    for root in ROOTS:
        monkeypatch.setattr(os, "urandom", stream(224))
        recs.append(run_on(fn, NAMES, root)[0])
    assert recs[0] == recs[1]
    # each package raised its own TlsError (the reference's test asserts
    # it with `pytest.raises(tls.TlsError)`); the two types are alike
    assert [c.__name__ for c in ttls.TlsError.__mro__] == \
        [c.__name__ for c in jtls.TlsError.__mro__]
