"""Shredder: entry batch -> signed merkle FEC sets (copy of the JAX
package's shred/shredder.py).

Pipeline per FEC set (ref: src/disco/shred/fd_shredder.c:130-320):
  1. split the entry-batch chunk into data-shred payloads (Agave's
     sizing policy: 31840-byte normal sets of 32x995B, one odd-sized
     tail set — count_* below reproduce the reference's closed-form
     tables, fd_shredder.h:171-234)
  2. Reed-Solomon-extend the data shreds' post-signature bytes into
     parity shreds — on device this is the GF(2^8) bit-matrix matmul
     (ops/reedsol.py) stretched over all byte positions at once
  3. hash every shred's merkle region into a leaf, build the
     20-byte-node tree, write each shred's inclusion proof
  4. sign the root (sign_fn is the keyguard seam — the identity key
     holder is elsewhere, ref src/disco/keyguard/fd_keyguard.h), stamp
     the signature into every shred
  5. chained variants thread root_{i} into set_{i+1}'s payload region

The RS + leaf-sha256 stages are the batch-shaped hot path; both have
device ops (ops/reedsol.py, ops/cuda_sha256.py). The framing/bookkeeping
here is host-side by design (tiny, branchy, per-set).

Where the copy differs from the reference: rs_backend="torch" (the
counterpart of the reference's "jax") computes the parity with
ops/reedsol.encode on the shredder's `device`; the default stays "host"
(utils/gf256). There is no `tpool` (the port has no utils/tpool), so the
leaves hash on the calling thread.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import gf256
from . import format as fmt
from .merkle import MerkleTree20, bmtree_depth, shred_merkle_leaf

# parity shreds for a given data shred count in the "normal" regime
# (Agave's table, fd_shredder.h:45-49); beyond 32 data shreds parity
# count equals data count (fd_shredder.h:218-219)
DATA_TO_PARITY = (
    0, 17, 18, 19, 19, 20, 21, 21,
    22, 23, 23, 24, 24, 25, 25, 26,
    26, 26, 27, 27, 28, 28, 29, 29,
    29, 30, 30, 31, 31, 31, 32, 32, 32)

NORMAL_FEC_PAYLOAD = 31840      # 32 data shreds x 995 B
CHAINED_FEC_PAYLOAD = 30816     # 32 x 963
RESIGNED_FEC_PAYLOAD = 28768    # 32 x 899

# odd-set payload-per-shred tiers: (max remaining bytes, payload/shred)
# for each (chained, resigned) regime (fd_shredder.h:186-234)
_TIERS = {
    (False, False): ((9135, 1015), (31840, 995), (62400, 975), (None, 955)),
    (True, False): ((8847, 983), (30816, 963), (60352, 943), (None, 923)),
    (True, True): ((8271, 919), (28768, 899), (56256, 879), (None, 859)),
}


def _fec_payload(chained: bool, resigned: bool) -> int:
    if resigned:
        return RESIGNED_FEC_PAYLOAD
    return CHAINED_FEC_PAYLOAD if chained else NORMAL_FEC_PAYLOAD


def count_fec_sets(sz: int, chained: bool, resigned: bool = False) -> int:
    pl = _fec_payload(chained, resigned)
    return max(sz, 2 * pl - 1) // pl


def _odd_set_data_cnt(rem: int, chained: bool, resigned: bool) -> int:
    for bound, payload in _TIERS[(chained, resigned)]:
        if bound is None or rem <= bound:
            return max(1, (rem + payload - 1) // payload)
    raise AssertionError


def count_data_shreds(sz: int, chained: bool, resigned: bool = False) -> int:
    normal = count_fec_sets(sz, chained, resigned) - 1
    rem = sz - normal * _fec_payload(chained, resigned)
    return normal * 32 + _odd_set_data_cnt(rem, chained, resigned)


def count_parity_shreds(sz: int, chained: bool,
                        resigned: bool = False) -> int:
    normal = count_fec_sets(sz, chained, resigned) - 1
    rem = sz - normal * _fec_payload(chained, resigned)
    d = _odd_set_data_cnt(rem, chained, resigned)
    return normal * 32 + (DATA_TO_PARITY[d] if d < len(DATA_TO_PARITY)
                          else d)


@dataclass
class FecSet:
    """One produced FEC set: wire-ready shreds + the signed root."""
    data_shreds: list
    parity_shreds: list
    merkle_root: bytes
    fec_set_idx: int


class Shredder:
    """Stateful per-slot shredder (idx bookkeeping across batches,
    fd_shredder.h:249-266)."""

    def __init__(self, sign_fn, shred_version: int = 0,
                 rs_backend: str = "host", device="cuda"):
        """rs_backend: "host" (utils/gf256) or "torch" (ops/reedsol on
        `device`, the card unless "cpu" is asked for)."""
        if rs_backend not in ("host", "torch"):
            raise ValueError(f"rs_backend {rs_backend!r}: host | torch")
        self.sign_fn = sign_fn
        self.shred_version = shred_version
        self.rs_backend = rs_backend
        self.device = device
        self.slot = None
        self.data_idx = 0
        self.parity_idx = 0

    def _set_slot(self, slot: int):
        if slot != self.slot:
            self.slot = slot
            self.data_idx = 0
            self.parity_idx = 0

    def _rs_encode(self, data_mat: np.ndarray, p: int) -> np.ndarray:
        if self.rs_backend == "torch":
            from ..ops import reedsol
            return reedsol.encode(data_mat, p, self.device).cpu().numpy()
        return gf256.encode(data_mat, p)

    def shred_batch(self, entry_batch: bytes, slot: int, parent_off: int,
                    ref_tick: int, block_complete: bool,
                    chained_root: bytes | None = None) -> list:
        """Shred one entry batch; returns its FEC sets in order.

        chained_root: 32-byte root of the previous FEC set to chain
        from (enables the chained variants; resigned is chained +
        block_complete, fd_shredder.c:154-155). The retransmitter
        signature slot of resigned shreds is left zeroed for the
        turbine retransmitter to fill.
        """
        assert entry_batch, "empty batch"
        self._set_slot(slot)
        chained = chained_root is not None
        sets = []
        offset = 0
        sz = len(entry_batch)
        while offset < sz:
            remaining = sz - offset
            resigned = chained and block_complete
            fec_pl = _fec_payload(chained, resigned)
            chunk = fec_pl if remaining >= 2 * fec_pl else remaining
            last_in_batch = offset + chunk == sz
            fs = self._one_fec_set(
                entry_batch[offset:offset + chunk], slot, parent_off,
                ref_tick, block_complete, last_in_batch, chained_root)
            offset += chunk
            if chained:
                chained_root = fs.merkle_root
            sets.append(fs)
        return sets

    def _one_fec_set(self, chunk: bytes, slot: int, parent_off: int,
                     ref_tick: int, block_complete: bool,
                     last_in_batch: bool,
                     chained_root: bytes | None) -> FecSet:
        chained = chained_root is not None
        # resigned is chained + block_complete (fd_shredder.c:155)
        resigned = chained and block_complete
        d_cnt = count_data_shreds(len(chunk), chained, resigned)
        p_cnt = count_parity_shreds(len(chunk), chained, resigned)
        tree_depth = bmtree_depth(d_cnt + p_cnt) - 1
        if chained:
            d_type = (fmt.TYPE_MERKLE_DATA_CHAINED_RESIGNED if resigned
                      else fmt.TYPE_MERKLE_DATA_CHAINED)
            c_type = (fmt.TYPE_MERKLE_CODE_CHAINED_RESIGNED if resigned
                      else fmt.TYPE_MERKLE_CODE_CHAINED)
        else:
            d_type, c_type = fmt.TYPE_MERKLE_DATA, fmt.TYPE_MERKLE_CODE
        d_variant = d_type | tree_depth
        c_variant = c_type | tree_depth
        payload_cap = fmt.payload_capacity(d_variant)
        rs_region = payload_cap + fmt.DATA_HEADER_SZ - fmt.SIGNATURE_SZ

        flags_last = ((0x80 if block_complete else 0) |
                      0x40) if last_in_batch else 0
        fec_set_idx = self.data_idx

        # -- data shreds (headers + payload; sig/proof patched below) --
        data_wires = []
        off = 0
        for i in range(d_cnt):
            pl = chunk[off:off + payload_cap]
            off += len(pl)
            flags = (ref_tick & fmt.REF_TICK_MASK) | \
                (flags_last if i == d_cnt - 1 else 0)
            s = fmt.DataShred(
                signature=bytes(64), variant=d_variant, slot=slot,
                idx=self.data_idx + i, version=self.shred_version,
                fec_set_idx=fec_set_idx, parent_off=parent_off,
                flags=flags, size=fmt.DATA_HEADER_SZ + len(pl),
                payload=pl, chained_root=chained_root,
                proof=tuple([bytes(20)] * tree_depth),
                retransmit_sig=bytes(64) if resigned else None)
            data_wires.append(bytearray(fmt.pack_data_shred(s)))
        assert off == len(chunk), (off, len(chunk))

        # -- RS parity over the post-signature region (batch-shaped) --
        data_mat = np.stack([
            np.frombuffer(bytes(w[64:64 + rs_region]), np.uint8)
            for w in data_wires])
        parity_mat = self._rs_encode(data_mat, p_cnt)

        code_wires = []
        for j in range(p_cnt):
            s = fmt.CodeShred(
                signature=bytes(64), variant=c_variant, slot=slot,
                idx=self.parity_idx + j, version=self.shred_version,
                fec_set_idx=fec_set_idx, data_cnt=d_cnt, code_cnt=p_cnt,
                code_idx=j, payload=parity_mat[j].tobytes(),
                chained_root=chained_root,
                proof=tuple([bytes(20)] * tree_depth),
                retransmit_sig=bytes(64) if resigned else None)
            code_wires.append(bytearray(fmt.pack_code_shred(s)))

        # -- merkle tree over all shreds' leaf regions --
        d_region = fmt.data_merkle_region_sz(d_variant)
        c_region = fmt.code_merkle_region_sz(c_variant)
        regions = [bytes(w[64:64 + d_region]) for w in data_wires] \
            + [bytes(w[64:64 + c_region]) for w in code_wires]
        leaves = [shred_merkle_leaf(r) for r in regions]
        tree = MerkleTree20(leaves)
        root = tree.root
        sig = self.sign_fn(root)
        assert len(sig) == 64

        for i, w in enumerate(data_wires):
            w[:64] = sig
            m_off = fmt.merkle_off(d_variant)
            for k, node in enumerate(tree.proof(i)):
                w[m_off + 20 * k:m_off + 20 * (k + 1)] = node
        for j, w in enumerate(code_wires):
            w[:64] = sig
            m_off = fmt.merkle_off(c_variant)
            for k, node in enumerate(tree.proof(d_cnt + j)):
                w[m_off + 20 * k:m_off + 20 * (k + 1)] = node

        self.data_idx += d_cnt
        self.parity_idx += p_cnt
        return FecSet([bytes(w) for w in data_wires],
                      [bytes(w) for w in code_wires], root, fec_set_idx)
