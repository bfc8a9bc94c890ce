"""The port's FEC resolver (firedancer_tpu_torch/shred/fec_resolver.py,
recovery on the host's GF(2^8)) and its store and reassembler
(shred/store.py) against the JAX package's: the cases of
tests/test_fec_resolver.py (a complete set, recovery from parity with and
without chained roots, data-only completion, a bad signature, a bad
proof, equivocation), all data lost, and a leader that signed parity
inconsistent with its data (the recovered tree's root mismatch), each fed
the same wires from the port's Shredder. Every add_shred result and
every metric must be equal (exact)."""
import dataclasses

import numpy as np
import pytest

from firedancer_tpu.shred import fec_resolver as jfec
from firedancer_tpu.shred import store as jstore
from firedancer_tpu.utils import ed25519_ref as jed
from firedancer_tpu_torch.shred import fec_resolver as tfec
from firedancer_tpu_torch.shred import format as fmt
from firedancer_tpu_torch.shred import store as tstore
from firedancer_tpu_torch.shred.merkle import MerkleTree20, shred_merkle_leaf
from firedancer_tpu_torch.shred.shredder import Shredder
from firedancer_tpu_torch.utils.ed25519_ref import keypair, sign, verify

SEED = bytes(range(32))
PUB = keypair(SEED)[-1]


def make_sets(nbytes, seed, chained=False):
    batch = np.random.default_rng(seed).integers(
        0, 256, nbytes, np.uint8).tobytes()
    sh = Shredder(sign_fn=lambda root: sign(SEED, root), shred_version=7)
    return batch, sh.shred_batch(batch, slot=9, parent_off=1, ref_tick=3,
                                 block_complete=True,
                                 chained_root=bytes(32) if chained else None)


def wires_of(sets, drop=()):
    """Every set's wires, data first, less the per-set indices in drop."""
    return [w for fs in sets for i, w in enumerate(
        list(fs.data_shreds) + list(fs.parity_shreds)) if i not in drop]


def inconsistent(fs):
    """The set re-signed over parity that is not its data's: each shred
    proves the signed root, but data recovered from the parity does
    not."""
    data = [bytearray(w) for w in fs.data_shreds]
    code = [bytearray(w) for w in fs.parity_shreds]
    for w in code:
        w[fmt.CODE_HEADER_SZ + 5] ^= 0xFF
    dv, cv = data[0][fmt.VARIANT_OFF], code[0][fmt.VARIANT_OFF]
    tree = MerkleTree20(
        [shred_merkle_leaf(bytes(w[64:64 + fmt.data_merkle_region_sz(dv)]))
         for w in data]
        + [shred_merkle_leaf(bytes(w[64:64 + fmt.code_merkle_region_sz(cv)]))
           for w in code])
    sig = sign(SEED, tree.root)
    for i, w in enumerate(data + code):
        w[:64] = sig
        off = fmt.merkle_off(w[fmt.VARIANT_OFF])
        for kk, node in enumerate(tree.proof(i)):
            w[off + 20 * kk:off + 20 * (kk + 1)] = node
    return [bytes(w) for w in data + code]


def _case(name):
    """-> (wires, verify_sig accepting the leader)."""
    ok = True
    if name == "complete":
        _, sets = make_sets(5000, 1)
        wires = wires_of(sets)
    elif name.startswith("recovery"):
        _, sets = make_sets(12_000, 2, chained=name.endswith("chained"))
        wires = wires_of(sets, drop={0, 3, 5})
    elif name == "all_data_lost":
        _, sets = make_sets(800, 8, chained=True)
        d = len(sets[0].data_shreds)
        assert d <= len(sets[0].parity_shreds)
        wires = wires_of(sets, drop=set(range(d)))
    elif name == "data_only":
        _, sets = make_sets(3000, 3)
        wires = list(sets[0].data_shreds)
    elif name == "bad_signature":
        _, sets = make_sets(2000, 4)
        wires, ok = list(sets[0].data_shreds), False
    elif name == "bad_proof":
        _, sets = make_sets(2000, 5)
        w = bytearray(sets[0].data_shreds[0])
        w[0x100] ^= 1
        wires = [bytes(w)] + list(sets[0].data_shreds[1:])
    elif name == "equivocation":
        sa, sb = make_sets(2000, 6)[1][0], make_sets(2000, 7)[1][0]
        wires = [sa.data_shreds[0], sb.data_shreds[1], sb.parity_shreds[0]]
    elif name == "root_mismatch":
        _, sets = make_sets(6000, 9)
        ws = inconsistent(sets[0])
        wires = ws[1:]                       # data shred 0 lost
    return wires, ok


CASES = ["complete", "recovery", "recovery_chained", "all_data_lost",
         "data_only", "bad_signature", "bad_proof", "equivocation",
         "root_mismatch"]


@pytest.mark.parametrize("name", CASES)
def test_fec_resolver_matches_reference(name):
    wires, ok = _case(name)
    runs = []
    for mod, ver in ((jfec, jed.verify), (tfec, verify)):
        r = mod.FecResolver(verify_sig=(
            lambda sig, root, slot, v=ver: ok and v(sig, PUB, root)))
        out = []
        for w in wires:
            done, eq = r.add_shred(w)
            out.append((None if done is None
                        else dataclasses.astuple(done), eq))
        runs.append((out, dict(r.metrics)))
    assert runs[1] == runs[0]
    m = runs[1][1]
    done = [d for d, _ in runs[1][0] if d is not None]
    expect = {"complete": ("completed", 1), "recovery": ("recovered", 3),
              "recovery_chained": ("recovered", 3),
              "data_only": ("completed", 1), "bad_signature": ("bad_sig", 1),
              "equivocation": ("eqvoc", 1),
              "root_mismatch": ("root_mismatch", 1)}
    if name == "all_data_lost":
        assert m["recovered"] == len(done[0][3]) and len(done) == 1
    elif name == "bad_proof":
        # the flipped byte breaks the proof to the signed root, so the
        # first shred's root fails its signature (as the reference's test)
        assert m["bad_sig"] + m["bad_proof"] == 1 and not done
    else:
        key, least = expect[name]
        assert m[key] >= least, m
    if name in ("bad_signature", "root_mismatch", "equivocation"):
        assert not done


def test_store_and_reassembler_match_reference():
    """FecStore (insert, duplicate, FIFO eviction, query, root prune) and
    the Reassembler (slices out of order sets, a late duplicate after the
    slot completed, the root guard) give the same results."""
    _, sets = make_sets(100_000, 12)
    fecs = []
    r = tfec.FecResolver(lambda sig, root, slot: verify(sig, PUB, root))
    for w in wires_of(sets):
        done, _ = r.add_shred(w)
        if done is not None:
            fecs.append(done)
    assert len(fecs) == len(sets) >= 3
    order = [fecs[1], fecs[0]] + fecs[2:] + [fecs[0]]
    runs = []
    for mod in (jstore, tstore):
        st = mod.FecStore(max_sets=2)
        ins = [st.insert(f.merkle_root, f.slot + i % 2, f.fec_set_idx,
                         b"".join(f.data_payloads))
               for i, f in enumerate(order)]
        q = [st.query(f.merkle_root) for f in fecs]
        st.publish(10)
        ra = mod.Reassembler()
        slices = [[dataclasses.astuple(s) for s in ra.add_fec(f)]
                  for f in order]
        ra.publish(10)
        late = ra.add_fec(fecs[0])
        runs.append((ins, q, len(st), dict(st.metrics), slices, late,
                     dict(ra.metrics)))
    assert runs[1] == runs[0]
    whole = b"".join(s[2] for per in runs[1][4] for s in per)
    assert whole == b"".join(b"".join(f.data_payloads) for f in fecs)
