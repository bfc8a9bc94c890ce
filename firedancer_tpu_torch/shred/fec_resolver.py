"""FEC resolver: shreds off the wire -> completed, validated FEC sets
(copy of the JAX package's shred/fec_resolver.py; recovery stays on the
host's GF(2^8), utils/gf256, as in the reference).

The non-leader half of the shred tile (ref: src/disco/shred/
fd_fec_resolver.c): group incoming shreds by (slot, fec_set_idx),
validate each against the set's signed merkle root via its inclusion
proof, verify the leader's signature over the root once per set, and on
reaching data_cnt total shreds Reed-Solomon-recover any missing data
shreds. A completed set re-derives the FULL merkle tree (recovered data
+ re-encoded parity) and requires the recomputed root to equal the
signed root — recovery can never launder corrupted bytes into the block
(the reference's recovered-shred re-validation).

Conflicting roots for one set key are surfaced as equivocation
(ref: src/choreo/eqvoc/fd_eqvoc.h — same key, different merkle root),
not silently dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import gf256
from . import format as fmt
from .merkle import MerkleTree20, root_from_proof, shred_merkle_leaf


@dataclass
class CompletedFec:
    slot: int
    fec_set_idx: int
    merkle_root: bytes
    data_payloads: list        # per data shred, size-trimmed payload bytes
    data_complete: bool        # last shred carries DATA_COMPLETE
    slot_complete: bool
    recovered_cnt: int


@dataclass
class _SetState:
    root: bytes | None = None
    signature: bytes | None = None
    sig_ok: bool = False
    data: dict = field(default_factory=dict)     # tree pos -> wire bytes
    code: dict = field(default_factory=dict)     # code_idx -> wire bytes
    data_cnt: int | None = None                  # from any code shred
    code_cnt: int | None = None
    variant_data: int | None = None
    variant_code: int | None = None
    done: bool = False


class FecError(ValueError):
    pass


class FecResolver:
    """verify_sig(sig, root, slot) -> bool is the keyguard-side seam
    (leader schedule lookup + ed25519 verify; batched on device in the
    gossvf-style pipeline)."""

    def __init__(self, verify_sig, max_pending: int = 1024):
        self.verify_sig = verify_sig
        self.max_pending = max_pending
        self.sets: dict[tuple[int, int], _SetState] = {}
        self.metrics = {"shreds": 0, "bad_proof": 0, "bad_sig": 0,
                        "eqvoc": 0, "completed": 0, "recovered": 0,
                        "dup": 0, "root_mismatch": 0}

    # -- per-shred ingest ---------------------------------------------------

    def add_shred(self, wire: bytes):
        """Returns (CompletedFec | None, EquivocationKey | None)."""
        self.metrics["shreds"] += 1
        s = fmt.parse_shred(wire)
        variant = wire[fmt.VARIANT_OFF]
        is_data = fmt.is_data(variant)
        key = (s.slot, s.fec_set_idx)
        st = self.sets.get(key)
        if st is None:
            if len(self.sets) >= self.max_pending:
                # evict the oldest pending set (reference uses a fixed
                # pool with FIFO reuse)
                self.sets.pop(next(iter(self.sets)))
            st = self.sets[key] = _SetState()
        if st.done:
            self.metrics["dup"] += 1
            return None, None

        # tree position + merkle region
        if is_data:
            pos = s.idx - s.fec_set_idx
            region = fmt.data_merkle_region_sz(variant)
        else:
            if st.data_cnt is None:
                st.data_cnt, st.code_cnt = s.data_cnt, s.code_cnt
            elif (st.data_cnt, st.code_cnt) != (s.data_cnt, s.code_cnt):
                self.metrics["eqvoc"] += 1
                return None, key
            pos = s.data_cnt + s.code_idx
            region = fmt.code_merkle_region_sz(variant)
        if pos < 0 or region > len(wire):
            self.metrics["bad_proof"] += 1
            return None, None

        # inclusion proof -> root; first shred pins (root, signature)
        leaf = shred_merkle_leaf(wire[64:64 + region])
        root = _root_from_proof(leaf, pos, wire, variant)
        if root is None:
            self.metrics["bad_proof"] += 1
            return None, None
        if st.root is None:
            if not self.verify_sig(wire[:64], root, s.slot):
                self.metrics["bad_sig"] += 1
                return None, None
            st.root, st.signature, st.sig_ok = root, wire[:64], True
        elif st.root != root:
            # same FEC set key, different signed root: equivocation
            self.metrics["eqvoc"] += 1
            return None, key

        if is_data:
            st.variant_data = variant
            if pos in st.data:
                self.metrics["dup"] += 1
                return None, None
            st.data[pos] = wire
        else:
            st.variant_code = variant
            if s.code_idx in st.code:
                self.metrics["dup"] += 1
                return None, None
            st.code[s.code_idx] = wire

        return self._try_complete(key, st), None

    # -- completion / recovery ----------------------------------------------

    def _try_complete(self, key, st: _SetState):
        d = st.data_cnt
        if d is None:
            # no code shred yet: complete only if the data shreds alone
            # cover the set (DATA_COMPLETE seen and all present)
            if not st.data:
                return None
            last = max(st.data)
            ds = fmt.parse_shred(st.data[last])
            if not (ds.data_complete or ds.slot_complete):
                return None
            d = last + 1
            if len(st.data) < d:
                return None
        if len(st.data) + len(st.code) < d:
            return None

        recovered = 0
        if len(st.data) < d:
            if st.variant_code is None:
                return None
            recovered = d - len(st.data)
            if not self._recover(st, d):
                self.metrics["root_mismatch"] += 1
                self.sets.pop(key, None)
                return None
        st.done = True
        self.metrics["completed"] += 1
        self.metrics["recovered"] += recovered

        payloads = []
        slot_complete = data_complete = False
        for i in range(d):
            ds = fmt.parse_shred(st.data[i])
            payloads.append(ds.payload[:ds.size - fmt.DATA_HEADER_SZ])
            slot_complete |= ds.slot_complete
            data_complete |= ds.data_complete
        st.data.clear()
        st.code.clear()
        return CompletedFec(key[0], key[1], st.root, payloads,
                            data_complete, slot_complete, recovered)

    def _recover(self, st: _SetState, d: int) -> bool:
        """RS-recover missing data shreds; True iff the re-derived full
        tree reproduces the signed root."""
        p = st.code_cnt
        vd, vc = st.variant_data, st.variant_code
        if vd is None:
            # all data missing is unrecoverable without knowing the data
            # variant; derive it from the code variant's type pairing
            vd = {fmt.TYPE_MERKLE_CODE: fmt.TYPE_MERKLE_DATA,
                  fmt.TYPE_MERKLE_CODE_CHAINED: fmt.TYPE_MERKLE_DATA_CHAINED,
                  fmt.TYPE_MERKLE_CODE_CHAINED_RESIGNED:
                      fmt.TYPE_MERKLE_DATA_CHAINED_RESIGNED}[
                fmt.shred_type(vc)] | (vc & 0x0F)
        rs_region = fmt.payload_capacity(vd) + fmt.DATA_HEADER_SZ \
            - fmt.SIGNATURE_SZ
        shreds = {}
        for pos, w in st.data.items():
            shreds[pos] = np.frombuffer(
                w[64:64 + rs_region], np.uint8)
        for ci, w in st.code.items():
            pl_off = fmt.CODE_HEADER_SZ
            shreds[d + ci] = np.frombuffer(
                w[pl_off:pl_off + rs_region], np.uint8)
        try:
            data_mat = gf256.recover(shreds, d, p)
        except ValueError:
            return False
        # the chained root rides OUTSIDE the RS region but INSIDE the
        # merkle leaf; it is identical across the set, so recovered
        # shreds take it from any originally-present one
        chain = b""
        if fmt.is_chained(vd):
            if st.data:
                src = next(iter(st.data.values()))
                co = fmt.chain_off(vd)
            else:
                src = next(iter(st.code.values()))
                co = fmt.chain_off(st.variant_code)
            chain = bytes(src[co:co + fmt.MERKLE_ROOT_SZ])
        # rebuild missing data wires (signature + recovered region +
        # chain root; the proof tail is stamped after tree rebuild)
        sz_wire = fmt.shred_sz(vd)
        present_data = set(st.data)
        for i in range(d):
            if i in present_data:
                continue
            w = bytearray(sz_wire)
            w[:64] = st.signature
            w[64:64 + rs_region] = data_mat[i].tobytes()
            if chain:
                co = fmt.chain_off(vd)
                w[co:co + fmt.MERKLE_ROOT_SZ] = chain
            st.data[i] = bytes(w)
        # integrity: recompute the FULL tree (data + re-encoded parity)
        full_parity = gf256.encode(data_mat, p)
        d_region = fmt.data_merkle_region_sz(vd)
        c_region = fmt.code_merkle_region_sz(st.variant_code)
        leaves = [shred_merkle_leaf(st.data[i][64:64 + d_region])
                  for i in range(d)]
        for j in range(p):
            if j in st.code:
                leaves.append(shred_merkle_leaf(
                    st.code[j][64:64 + c_region]))
            else:
                # reconstruct the code shred's merkle region from the
                # common header fields + recomputed parity + chain root
                hdr = _synth_code_header(st, d, p, j)
                leaf_bytes = hdr + full_parity[j].tobytes() + chain
                assert len(leaf_bytes) == c_region, (len(leaf_bytes),
                                                    c_region)
                leaves.append(shred_merkle_leaf(leaf_bytes))
        tree = MerkleTree20(leaves)
        if tree.root != st.root:
            return False
        # stamp proofs into recovered data shreds so downstream
        # re-validation (store, repair served shreds) passes
        m_off = fmt.merkle_off(vd)
        for i in range(d):
            w = bytearray(st.data[i])
            for kk, node in enumerate(tree.proof(i)):
                w[m_off + 20 * kk:m_off + 20 * (kk + 1)] = node
            st.data[i] = bytes(w)
        return True


def _synth_code_header(st: _SetState, d: int, p: int, j: int) -> bytes:
    """Post-signature header of a missing code shred (for leaf
    recomputation): variant..code_idx fields, per fmt.pack_code_shred."""
    import struct
    any_code = next(iter(st.code.values())) if st.code else None
    if any_code is not None:
        slot, = struct.unpack_from("<Q", any_code, 0x41)
        version, = struct.unpack_from("<H", any_code, 0x4D)
        fec_set_idx, = struct.unpack_from("<I", any_code, 0x4F)
        base_idx, = struct.unpack_from("<I", any_code, 0x49)
        base_code_idx, = struct.unpack_from("<H", any_code, 0x57)
        idx = base_idx - base_code_idx + j
    else:
        any_data = st.data[next(iter(st.data))]
        slot, = struct.unpack_from("<Q", any_data, 0x41)
        version, = struct.unpack_from("<H", any_data, 0x4D)
        fec_set_idx, = struct.unpack_from("<I", any_data, 0x4F)
        idx = j        # unknowable without a code shred; see caller
    return (bytes([st.variant_code]) + struct.pack("<Q", slot)
            + struct.pack("<I", idx) + struct.pack("<H", version)
            + struct.pack("<I", fec_set_idx)
            + struct.pack("<HHH", d, p, j))


def _root_from_proof(leaf: bytes, pos: int, wire: bytes,
                     variant: int) -> bytes | None:
    depth = fmt.merkle_cnt(variant)
    m_off = fmt.merkle_off(variant)
    if m_off + 20 * depth > len(wire):
        return None
    proof = [wire[m_off + 20 * k: m_off + 20 * (k + 1)]
             for k in range(depth)]
    return root_from_proof(leaf, pos, proof)
