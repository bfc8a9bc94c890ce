"""The port's precompiles (firedancer_tpu_torch/svm/precompiles.py on
utils/keccak.py, utils/secp256k1.py, utils/secp256r1.py and
utils/ed25519_ref.py) against the JAX package's: the cases of
tests/test_precompiles.py, each run through both packages' executors
with equal statuses, fees, logs and accounts (tests/torch_svm_parity.
Both), the host curve code on both, and the P-256 signer of
tools/general_exec.py that the workload signs with. The pure-Python
secp256k1 recovery and secp256r1 verification are slow on the host:
`test_host_verify_costs` times them (printed with -s)."""
import struct
import time

import pytest

from torch_svm_parity import JAX, PKGS, TORCH, Both, k, txn
from firedancer_tpu.utils import ed25519_ref as jed
from firedancer_tpu.utils import keccak as jkeccak
from firedancer_tpu.utils import secp256k1 as jk1
from firedancer_tpu.utils import secp256r1 as jr1
from firedancer_tpu_torch.tools import general_exec as gx
from firedancer_tpu_torch.utils import ed25519_ref as ted
from firedancer_tpu_torch.utils import keccak as tkeccak
from firedancer_tpu_torch.utils import secp256k1 as tk1
from firedancer_tpu_torch.utils import secp256r1 as tr1
from firedancer_tpu_torch.utils.ed25519_ref import keypair, sign

ED = TORCH.precompiles.ED25519_PROGRAM_ID
K1 = TORCH.precompiles.SECP256K1_PROGRAM_ID
R1 = TORCH.precompiles.SECP256R1_PROGRAM_ID


def _run(program_id, data):
    b = Both({k(1): 1_000_000}, enforce_rent=False)
    return b.run(txn([k(1)], [program_id], [(1, [], data)],
                     n_ro_unsigned=1))


def test_ids_match_reference():
    for name in ("ED25519_PROGRAM_ID", "SECP256K1_PROGRAM_ID",
                 "SECP256R1_PROGRAM_ID", "THIS_IX", "THIS_IX_U8"):
        assert getattr(TORCH.precompiles, name) == \
            getattr(JAX.precompiles, name)


@pytest.mark.parametrize("msg", [b"", b"abc", b"q" * 135, b"q" * 136,
                                 b"q" * 137, b"q" * 272, bytes(range(256))])
def test_keccak_matches_reference(msg):
    assert tkeccak.keccak256(msg) == jkeccak.keccak256(msg)
    assert tkeccak.keccak256(b"").hex().startswith("c5d2460186f7233c")


def test_secp256k1_sign_verify_recover_match_reference():
    priv = 0xC0FFEE1234567890C0FFEE1234567890C0FFEE1234567890C0FFEE12345678
    q = tk1._mul(priv, (tk1.GX, tk1.GY))
    assert q == jk1._mul(priv, (jk1.GX, jk1.GY))
    for i in range(3):
        h = tkeccak.keccak256(b"message-%d" % i)
        r, s, rec = tk1.sign(priv, h)
        assert (r, s, rec) == jk1.sign(priv, h)
        assert tk1.verify(q, h, r, s) and jk1.verify(q, h, r, s)
        assert tk1.recover(h, r, s, rec) == jk1.recover(h, r, s, rec) == q
        assert tk1.recover(h, r, s, rec ^ 1) == jk1.recover(h, r, s,
                                                            rec ^ 1)
    assert tk1.eth_address(q) == jk1.eth_address(q)


def test_ed25519_precompile_matches_reference():
    seed = bytes(range(32))
    pub = keypair(seed)[-1]
    msg = b"precompile me"
    sig = sign(seed, msg)
    assert _run(ED, gx.ed25519_ix([(sig, pub, msg)])) == "ok"
    bad = bytes([sig[0] ^ 1]) + sig[1:]
    assert _run(ED, gx.ed25519_ix([(bad, pub, msg)])) == "program_failed"
    assert _run(ED, bytes([2, 0]) + bytes(6)) == "bad_instruction_data"
    two = gx.ed25519_ix([(sig, pub, msg), (sign(seed, b"x"), pub, b"x")])
    assert _run(ED, two) == "ok"


def test_secp256k1_precompile_matches_reference():
    priv = 0xD00D
    msg = b"ethereum-flavored auth"
    sig65, addr = gx.secp256k1_sign(priv, msg)
    assert _run(K1, gx.secp256k1_ix(sig65, addr, msg)) == "ok"
    assert _run(K1, gx.secp256k1_ix(sig65, bytes(20), msg)) == \
        "program_failed"
    assert _run(K1, bytes([3]) + bytes(5)) == "bad_instruction_data"


def test_p256_signer_verifies_on_both_packages():
    """tools/general_exec.p256_sign (RFC 6979-style nonces from
    HMAC-SHA256, low s) makes signatures both packages' verifiers take."""
    for i in range(3):
        priv = 0x1234 + 7919 * i
        msg = b"p256-%d" % i
        pub33, sig = gx.p256_sign(priv, msg)
        assert gx.p256_sign(priv, msg) == (pub33, sig)
        assert tr1.verify(pub33, msg, sig) and jr1.verify(pub33, msg, sig)
        bad = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
        assert not tr1.verify(pub33, msg, bad)
        assert not jr1.verify(pub33, msg, bad)


def test_secp256r1_precompile_matches_reference():
    msg = b"p256 precompile"
    pub33, sig = gx.p256_sign(0xBEEF, msg)
    assert _run(R1, gx.secp256r1_ix(sig, pub33, msg)) == "ok"
    bad = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
    assert _run(R1, gx.secp256r1_ix(bad, pub33, msg)) == "program_failed"
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    highs = r.to_bytes(32, "big") + (tr1.N - s).to_bytes(32, "big")
    assert _run(R1, gx.secp256r1_ix(highs, pub33, msg)) == "program_failed"
    assert _run(R1, bytes([2, 0]) + bytes(6)) == "bad_instruction_data"
    assert _run(R1, bytes([9, 0]) + bytes(14 * 9)) == "bad_instruction_data"
    assert _run(R1, bytes([0, 0])) == "bad_instruction_data"


def test_secp256r1_openssl_signature_on_both():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature)
    key = ec.generate_private_key(ec.SECP256R1())
    pub33 = key.public_key().public_bytes(
        serialization.Encoding.X962,
        serialization.PublicFormat.CompressedPoint)
    msg = b"p256 precompile"
    r, s = decode_dss_signature(key.sign(msg, ec.ECDSA(hashes.SHA256())))
    s = min(s, tr1.N - s)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    assert _run(R1, gx.secp256r1_ix(sig, pub33, msg)) == "ok"


def test_host_verify_costs():
    """The host's cost of one verification a family, per package (the
    general bank runs these per precompile instruction)."""
    seed = bytes(range(32))
    pub = keypair(seed)[-1]
    sig = sign(seed, b"m")
    sig65, addr = gx.secp256k1_sign(0xD00D, b"m")
    pub33, sig_r1 = gx.p256_sign(0xBEEF, b"m")
    costs = {}
    for name, pkg in zip(("jax", "torch"), PKGS):
        k1 = (jk1, tk1)[pkg is TORCH]
        r1 = (jr1, tr1)[pkg is TORCH]
        kc = (jkeccak, tkeccak)[pkg is TORCH]
        ed = (jed, ted)[pkg is TORCH]
        t0 = time.perf_counter()
        assert ed.verify(sig, pub, b"m")
        t1 = time.perf_counter()
        r, s = int.from_bytes(sig65[:32], "big"), int.from_bytes(
            sig65[32:64], "big")
        q = k1.recover(kc.keccak256(b"m"), r, s, sig65[64])
        assert k1.eth_address(q) == addr
        t2 = time.perf_counter()
        assert r1.verify(pub33, b"m", sig_r1)
        t3 = time.perf_counter()
        costs[name] = {"ed25519_ms": (t1 - t0) * 1e3,
                       "secp256k1_ms": (t2 - t1) * 1e3,
                       "secp256r1_ms": (t3 - t2) * 1e3}
    print("host verify costs (ms):", costs)
    assert all(v < 1000 for c in costs.values() for v in c.values())


def test_precompile_offsets_by_instruction_index():
    """An offset's index may name an instruction by its real index (0xFFFF
    marks this one): index 0 is the precompile's own instruction here,
    and an index past the message is bad instruction data."""
    seed = bytes(range(32))
    pub = keypair(seed)[-1]
    msg = b"by index"
    body = sign(seed, msg) + pub + msg
    for ix, want in ((0, "ok"), (5, "bad_instruction_data")):
        hdr = bytes([1, 0]) + struct.pack("<HHHHHHH", 16, ix, 80, ix, 112,
                                          len(msg), ix)
        assert _run(ED, hdr + body) == want
