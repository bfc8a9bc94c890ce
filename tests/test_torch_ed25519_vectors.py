"""External vector gates for the port's strict verify (plain path):
every Wycheproof EdDSA vector and the malleability corpus, through
cuda_ed.verify_batch on CPU tensors (the glue, the wrappers and the
plain versions of both kernels). Verdicts must equal the files'."""
import json
import os

import numpy as np

from firedancer_tpu_torch.ops import cuda_ed

HERE = os.path.dirname(os.path.abspath(__file__))


def load_vectors():
    """-> (sig, pub, msg, msg_len, want) over all Wycheproof vectors and
    both malleability files (96-byte (sig, pub) records over "Zcash")."""
    recs = []
    with open(os.path.join(HERE, "vectors", "ed25519_wycheproof.json")) as f:
        for v in json.load(f):
            recs.append((bytes.fromhex(v["sig"]), bytes.fromhex(v["pub"]),
                         bytes.fromhex(v["msg"]), bool(v["ok"])))
    for name, expect in (("malleability_should_pass.bin", True),
                         ("malleability_should_fail.bin", False)):
        raw = open(os.path.join(HERE, "vectors", name), "rb").read()
        for off in range(0, len(raw), 96):
            recs.append((raw[off:off + 64], raw[off + 64:off + 96],
                         b"Zcash", expect))
    n = len(recs)
    max_len = max(len(r[2]) for r in recs)
    sig = np.zeros((n, 64), np.uint8)
    pub = np.zeros((n, 32), np.uint8)
    msg = np.zeros((n, max_len), np.uint8)
    ln = np.zeros(n, np.int32)
    want = np.zeros(n, bool)
    for i, (s, p, m, ok) in enumerate(recs):
        sig[i] = np.frombuffer(s, np.uint8)
        pub[i] = np.frombuffer(p, np.uint8)
        msg[i, :len(m)] = np.frombuffer(m, np.uint8)
        ln[i] = len(m)
        want[i] = ok
    return sig, pub, msg, ln, want


def test_vectors_match_expected_verdicts():
    sig, pub, msg, ln, want = load_vectors()
    got = cuda_ed.verify_batch(sig, pub, msg, ln, device="cpu").numpy()
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"{bad.size}/{len(want)} mismatches: {bad[:10]}"
    assert want.any() and not want.all()
