"""The conformance corpus through both packages' TxnExecutor: every
fixture of tests/vectors/conformance/ (bpf.json's deployed sBPF programs
included) and every hand vector of tests/test_conformance.py's VECTORS
run through the JAX package's executor and the port's
(firedancer_tpu_torch/svm/programs.py) on the same pre-state. Status,
fee, logs and return data, and every account of the fork (lamports,
data, owner, executable), must be equal (exact), and the fixture's own
expected effects must hold on the port."""
import json
import os

import pytest

import test_conformance as jconf
from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu.protocol.txn import build_message, build_txn
from firedancer_tpu.svm import accdb as jaccdb
from firedancer_tpu.svm import programs as jprog
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.svm import accdb as taccdb
from firedancer_tpu_torch.svm import programs as tprog

PKGS = ((jfunk, jaccdb, jprog), (tfunk, taccdb, tprog))
FIX_DIR = os.path.join(os.path.dirname(__file__), "vectors", "conformance")


def _fixtures():
    out = []
    for fn in sorted(os.listdir(FIX_DIR)):
        if fn.endswith(".json"):
            with open(os.path.join(FIX_DIR, fn)) as f:
                out.extend(json.load(f))
    return out


FIXTURES = _fixtures()


def run_both(accounts, payload, enforce_rent, epoch=0, slot=0):
    """accounts: [(key, dict of Account fields)] written to each package's
    Funk root; the txn runs on the fork "blk". -> (port's result, port's
    fork accounts) once both packages agree."""
    got = []
    for fk, ad, pg in PKGS:
        funk = fk.Funk()
        for key, a in accounts:
            funk.rec_write(None, key, ad.Account(**a))
        funk.txn_prepare(None, "blk")
        ex = pg.TxnExecutor(ad.AccDb(funk), enforce_rent=enforce_rent)
        ex.epoch, ex.slot = epoch, slot
        r = ex.execute("blk", payload)
        accts = {key: (v.lamports, bytes(v.data), v.owner, v.executable)
                 for key, v in funk.items_at("blk").items()
                 if isinstance(v, ad.Account)}
        got.append(((r.status, r.fee, list(r.logs), r.return_data), accts))
    assert got[1] == got[0]
    return got[1]


def test_corpus_is_the_non_sbpf_fixtures():
    """The whole corpus: the 178 fixtures of the native programs and
    bpf.json's 4, whose deployed programs are executable accounts."""
    names = [f["name"] for f in FIXTURES]
    assert len(names) == len(set(names)) == 182
    sbpf = [f["name"] for f in FIXTURES
            if any(a.get("executable") for a in f["context"]["accounts"])]
    assert len(sbpf) == 4, sbpf


@pytest.mark.parametrize("fx", FIXTURES, ids=[f["name"] for f in FIXTURES])
def test_fixture_matches_reference(fx):
    ctx = fx["context"]
    accounts = [(bytes.fromhex(a["address"]), dict(
        lamports=a["lamports"], data=bytearray(bytes.fromhex(a["data"])),
        owner=bytes.fromhex(a["owner"]),
        executable=a.get("executable", False))) for a in ctx["accounts"]]
    tx = ctx["tx"]
    signers = [bytes.fromhex(s) for s in tx["signers"]]
    msg = build_message(
        signers, [bytes.fromhex(e) for e in tx["extra"]], b"\x11" * 32,
        [(i["program_index"], bytes(i["accounts"]),
          bytes.fromhex(i["data"])) for i in tx["instructions"]],
        n_ro_signed=tx.get("n_ro_signed", 0),
        n_ro_unsigned=tx.get("n_ro_unsigned", 0))
    (status, fee, _, _), accts = run_both(
        accounts, build_txn([bytes(64)] * len(signers), msg),
        ctx.get("enforce_rent", True), ctx.get("epoch", 0),
        ctx.get("slot", 0))
    eff = fx["effects"]
    assert (status, fee) == (eff["status"], eff["fee"])
    for want in eff["accounts"]:
        lam, data, _, _ = accts.get(bytes.fromhex(want["address"]),
                                    (0, b"", None, None))
        assert lam == want["lamports"]
        if "data" in want:
            assert data == bytes.fromhex(want["data"])


@pytest.mark.parametrize("vec", jconf.VECTORS,
                         ids=[v["name"] for v in jconf.VECTORS])
def test_hand_vector_matches_reference(vec):
    accounts = []
    for key, spec in vec["pre"].items():
        spec = {"lamports": spec} if isinstance(spec, int) else spec
        accounts.append((key, dict(
            lamports=spec.get("lamports", 0),
            data=spec.get("data", b""),
            owner=spec.get("owner", bytes(32)),
            executable=spec.get("executable", False))))
    msg = build_message(
        vec["signers"], vec["extra"], b"\x11" * 32,
        [(p, bytes(ai), d) for p, ai, d in vec["instrs"]],
        n_ro_signed=vec.get("n_ro_signed", 0),
        n_ro_unsigned=vec.get("n_ro_unsigned", 0))
    (status, fee, _, _), accts = run_both(
        accounts, build_txn([bytes(64)] * len(vec["signers"]), msg),
        vec.get("enforce_rent", False))
    assert (status, fee) == (vec["expect"], vec["fee"])
    for key, want in vec.get("post", {}).items():
        assert accts.get(key, (0,))[0] == want
