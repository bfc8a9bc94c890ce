"""The port's shred leg (firedancer_tpu_torch/shred/ and tiles/shred.py)
against the JAX package's: the Shredder's FEC sets byte for byte (normal,
chained and resigned, block_complete both ways, Reed-Solomon on the host
and through ops/reedsol on the CPU), the count tables and the turbine
tree, every shred's proof and signature, and ShredLeaderCore fed the same
PoH entry frames (sendto sequence, mirror wires, witness batches and
metrics); then the reference's ShredRecoverCore reassembles the port's
wires (tests/test_shred_tile.py:192, in process). Exact: wires are
bytes."""
import dataclasses
import hashlib
import os
import struct

import numpy as np
import pytest

from firedancer_tpu import runtime as jrt
from firedancer_tpu.ops.poh import host_poh_append, host_poh_mixin
from firedancer_tpu.shred import format as jfmt
from firedancer_tpu.shred import shred_dest as jdest
from firedancer_tpu.shred import shredder as jshredder
from firedancer_tpu.tiles import shred as jtile
from firedancer_tpu.tiles.synth import make_signed_txns
from firedancer_tpu.utils import ed25519_ref as jed
from firedancer_tpu_torch import runtime as trt
from firedancer_tpu_torch.shred import format as fmt
from firedancer_tpu_torch.shred import shred_dest as dest
from firedancer_tpu_torch.shred import shredder
from firedancer_tpu_torch.shred.merkle import shred_merkle_leaf, verify_proof
from firedancer_tpu_torch.tiles import shred as tile
from firedancer_tpu_torch.utils import ed25519_ref as ed

SEED = bytes(range(32))
PUB = ed.keypair(SEED)[-1]
PEER = b"\x55" * 32
# (chained, block_complete): normal, normal closing the block, chained,
# and resigned (chained + block_complete)
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]


def _batch(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8) \
        .tobytes()


def _sets(sets):
    return [(s.data_shreds, s.parity_shreds, s.merkle_root, s.fec_set_idx)
            for s in sets]


def _shred_both(batch, chained, complete, backend, slot=3):
    """The same batch through the reference's Shredder and the port's,
    each signing with its own ed25519_ref under SEED."""
    root = hashlib.sha256(b"prev-set").digest() if chained else None
    args = (batch, slot, 1, 5, complete, root)
    want = jshredder.Shredder(lambda r: jed.sign(SEED, r)).shred_batch(*args)
    got = shredder.Shredder(lambda r: ed.sign(SEED, r), rs_backend=backend,
                            device="cpu").shred_batch(*args)
    return got, want


@pytest.mark.parametrize("backend", ["host", "torch"])
@pytest.mark.parametrize("chained,complete", VARIANTS)
def test_shredder_sets_match_reference(chained, complete, backend):
    got, want = _shred_both(_batch(5000, 1), chained, complete, backend)
    assert _sets(got) == _sets(want)
    variant = got[0].data_shreds[0][fmt.VARIANT_OFF]
    assert fmt.is_data(variant)
    assert bool(got[-1].data_shreds[-1][0x55] & 0x80) == complete


def test_shredder_two_chained_sets_match_reference():
    """A batch of two FEC sets (a normal 32:32 set and the tail), chained
    root to root, parity through ops/reedsol on the CPU."""
    got, want = _shred_both(_batch(66000, 2), True, False, "torch")
    assert len(got) == 2 and len(got[0].data_shreds) == 32
    assert _sets(got) == _sets(want)


def test_shredder_keeps_indices_across_batches_of_a_slot():
    sh = shredder.Shredder(lambda r: ed.sign(SEED, r))
    ref = jshredder.Shredder(lambda r: jed.sign(SEED, r))
    for k, n in enumerate((900, 3000, 1)):
        for s in (sh, ref):
            s.shred_batch(_batch(n, 10 + k), 4, 1, k, False)
        assert (sh.data_idx, sh.parity_idx) == (ref.data_idx,
                                                 ref.parity_idx)


def test_shredder_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="rs_backend"):
        shredder.Shredder(lambda r: bytes(64), rs_backend="jax")


@pytest.mark.parametrize("chained,resigned", [(False, False), (True, False),
                                              (True, True)])
def test_count_tables_match_reference(chained, resigned):
    for sz in list(range(1, 2000, 97)) + [9135, 9136, 31840, 63679, 63680,
                                          100000, 300000]:
        for f in ("count_fec_sets", "count_data_shreds",
                  "count_parity_shreds"):
            assert getattr(shredder, f)(sz, chained, resigned) == \
                getattr(jshredder, f)(sz, chained, resigned), (f, sz)


def test_every_shred_proof_verifies_and_sig_covers_root():
    """tests/test_shred.py:150 with the port's modules."""
    sets = shredder.Shredder(lambda r: ed.sign(SEED, r)).shred_batch(
        b"\x5c" * 9000, slot=3, parent_off=1, ref_tick=0,
        block_complete=False)
    fs = sets[0]
    d_var = fmt.parse_shred(fs.data_shreds[0]).variant
    c_var = fmt.parse_shred(fs.parity_shreds[0]).variant
    d_cnt = len(fs.data_shreds)
    for i, w in enumerate(fs.data_shreds + fs.parity_shreds):
        var = d_var if i < d_cnt else c_var
        region = (fmt.data_merkle_region_sz(var) if i < d_cnt
                  else fmt.code_merkle_region_sz(var))
        s = fmt.parse_shred(w)
        assert verify_proof(shred_merkle_leaf(w[64:64 + region]), i,
                            list(s.proof), fs.merkle_root), i
        assert ed.verify(s.signature, PUB, fs.merkle_root)
        assert dataclasses.astuple(s) == \
            dataclasses.astuple(jfmt.parse_shred(w))


def test_turbine_first_hops_match_reference():
    rng = np.random.default_rng(4)
    nodes = [(rng.bytes(32), int(s)) for s in
             rng.integers(0, 1000, 40)] + [(rng.bytes(32), 0)
                                           for _ in range(5)]
    ident = nodes[3][0]
    mk = [[m.ClusterNode(pk, st, ("127.0.0.1", 1000 + i))
           for i, (pk, st) in enumerate(nodes)] for m in (dest, jdest)]
    d = dest.ShredDest(mk[0], ident, fanout=8)
    j = jdest.ShredDest(mk[1], ident, fanout=8)
    for slot, idx, typ in ((1, 0, 1), (1, 5, 0), (9, 31, 1), (200, 3, 0)):
        a = d.first_hop(slot, idx, typ, nodes[0][0])
        b = j.first_hop(slot, idx, typ, nodes[0][0])
        assert (a and (a.pubkey, a.addr)) == (b and (b.pubkey, b.addr))
        assert [n.pubkey for n in d.children(slot, idx, typ, ident)] == \
            [n.pubkey for n in j.children(slot, idx, typ, ident)]


# -- ShredLeaderCore ------------------------------------------------------

def _entry_frame(slot, tick, num_hashes, has_mix, prev, h, mixin,
                 slot_done=False, txns=()):
    blob = b"".join(struct.pack("<H", len(t)) + t for t in txns)
    return (struct.pack("<QIIB", slot, tick, num_hashes, has_mix)
            + prev + h + mixin + bytes([1 if slot_done else 0])
            + struct.pack("<H", len(txns)) + blob)


def _entries(slot, txn_groups, state, ticks=2, hashes_per_tick=8):
    """A poh-consistent entry stream for one slot (the poh tile's frame
    wire), as tests/test_shred_tile.py builds it."""
    frames, hashes, tick = [], 0, 0
    for txns in txn_groups:
        mixin = hashlib.sha256(b"".join(t[1:65] for t in txns)).digest()
        prev, state = state, host_poh_mixin(state, mixin)
        hashes += 1
        frames.append(_entry_frame(slot, tick, 1, 1, prev, state, mixin,
                                   txns=txns))
    for i in range(ticks):
        prev, state = state, host_poh_append(state, hashes_per_tick - hashes)
        frames.append(_entry_frame(slot, tick, hashes_per_tick - hashes, 0,
                                   prev, state, bytes(32),
                                   slot_done=(i == ticks - 1)))
        hashes, tick = 0, tick + 1
    return frames, state


class _Sock:
    def __init__(self):
        self.sent = []

    def sendto(self, wire, addr):
        self.sent.append((bytes(wire), addr))


class _Capture:
    def __init__(self):
        self.frames = []

    def publish(self, frame, sig=0):
        self.frames.append((bytes(frame), sig))


def _drain(ring):
    out, seq = [], 0
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out
        out.append((bytes(ring.payload(frag)), int(frag.sig)))
        seq += 1


@pytest.fixture(scope="module")
def leader_run():
    """Three slots of entries (one big enough for two FEC sets, flushed
    at flush_bytes before its slot completes) through both cores, each
    over its own package's mirror ring."""
    txns = make_signed_txns(40, seed=9)
    state, frames = bytes(32), []
    for slot, groups in ((7, [txns[:3], txns[3:6]]), (8, []),
                         (9, [txns[6 + 4 * k:10 + 4 * k] for k in range(8)])):
        f, state = _entries(slot, groups, state)
        frames += f
    out = {}
    for name, rt, core_mod, node, sign in (
            ("ref", jrt, jtile, jdest.ClusterNode,
             lambda r: jed.sign(SEED, r)),
            ("port", trt, tile, dest.ClusterNode,
             lambda r: ed.sign(SEED, r))):
        w = rt.Workspace(f"/fdt_sh{name}_{os.getpid()}", 1 << 23)
        try:
            mirror = rt.Ring.create(w, depth=1024, mtu=1280)
            sock, batches = _Sock(), _Capture()
            core = core_mod.ShredLeaderCore(
                sign, PUB, [node(PEER, 100, ("127.0.0.1", 9))], sock,
                out_ring=mirror, out_fseqs=[], batch_out=batches,
                flush_bytes=2000)
            sent_per_entry = [core.on_entry(f) for f in frames]
            core.flush_egress()
            out[name] = dict(sent=sock.sent, per_entry=sent_per_entry,
                             mirror=_drain(mirror), batches=batches.frames,
                             metrics=dict(core.metrics))
        finally:
            w.close()
            w.unlink()
    return out


def test_leader_core_matches_reference(leader_run):
    ref, port = leader_run["ref"], leader_run["port"]
    assert port["sent"] == ref["sent"]
    assert port["per_entry"] == ref["per_entry"]
    assert port["mirror"] == ref["mirror"]
    assert port["batches"] == ref["batches"]
    assert port["metrics"] == ref["metrics"]
    assert port["metrics"]["dropped"] == 0
    m = port["metrics"]
    assert m["slots"] == 3 and m["fec_sets"] > 3 and m["sign_fail"] == 0
    assert m["sent"] == m["data_shreds"] + m["parity_shreds"] \
        == len(port["mirror"])
    assert {a for _, a in port["sent"]} == {("127.0.0.1", 9)}


def test_reference_recover_core_reassembles_port_wires(leader_run):
    """The reference's recover half takes the port's turbine wires, in
    reverse order and with one data shred of each set lost, and
    reproduces every flushed batch byte for byte."""
    port = leader_run["port"]
    wires = [w for w, _ in port["sent"]]
    lost, seen = set(), set()
    for k, w in enumerate(wires):
        s = jfmt.parse_shred(w)
        key = (s.slot, s.fec_set_idx)
        if jfmt.is_data(w[jfmt.VARIANT_OFF]) and key not in seen:
            seen.add(key)
            lost.add(k)
    out = _Capture()
    rec = jtile.ShredRecoverCore(PUB, out, None)
    for k in reversed(range(len(wires))):
        if k not in lost:
            rec.on_shred(wires[k])
    assert rec.metrics["parse_fail"] == 0
    assert rec.metrics["slots_done"] == 3
    assert rec.resolver.metrics["recovered"] >= len(lost)
    by_slot = {}
    for f, _ in out.frames:
        slot, _, _, payload = jtile.parse_slice(f)
        by_slot[slot] = by_slot.get(slot, b"") + payload
    want = {}
    for f, _ in port["batches"]:
        slot, = struct.unpack_from("<Q", f, 0)
        want[slot] = want.get(slot, b"") + f[9:]
    assert by_slot == want
    entries = tile.parse_entry_batch(want[9])
    assert entries == jtile.parse_entry_batch(want[9])
    assert sum(len(t) for _, _, t in entries) == 32


def test_slice_frames_round_trip():
    f = tile.pack_slice(11, 4, True, b"abc")
    assert f == jtile.pack_slice(11, 4, True, b"abc")
    assert tile.parse_slice(f) == jtile.parse_slice(f) == (11, 4, True,
                                                           b"abc")
