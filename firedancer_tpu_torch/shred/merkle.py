"""FEC-set merkle commitment: 20-byte-node SHA-256 bmtree + proofs (copy
of the JAX package's shred/merkle.py).

Tree semantics (ref: src/ballet/bmtree/fd_bmtree.c:81-137, 327-345):
  * leaf node   = sha256("\\x00SOLANA_MERKLE_SHREDS_LEAF" ‖ leaf bytes)
  * merge       = sha256("\\x01SOLANA_MERKLE_SHREDS_NODE" ‖ L[:20] ‖ R[:20])
    — children are TRUNCATED to hash_sz=20 bytes at concat time; the
    stored node (and the root) keep the full 32-byte sha256 output
  * odd layer: last node pairs with itself
  * proof = the 20-byte sibling at each merge layer, leaf->root order
    (fd_bmtree_get_proof); the signed root is the full 32 bytes

The host tree here does FEC-set bookkeeping (proof extraction needs the
whole tree resident — ~128 nodes, trivially host-sized); the *leaf*
hashes — the wide, batch-shaped work — can come from the batched SHA-256
kernel (ops/cuda_sha256.sha256) via `MerkleTree20.from_leaf_hashes`.
"""
from __future__ import annotations

import hashlib

LEAF_PREFIX = b"\x00SOLANA_MERKLE_SHREDS_LEAF"
NODE_PREFIX = b"\x01SOLANA_MERKLE_SHREDS_NODE"
NODE_SZ = 20


def shred_merkle_leaf(shred_bytes_past_sig: bytes) -> bytes:
    """Leaf hash over a shred's merkle region (the bytes from the
    variant byte through the chained root, fd_shredder.c:267-269)."""
    return hashlib.sha256(LEAF_PREFIX + shred_bytes_past_sig).digest()


def _merge(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(
        NODE_PREFIX + left[:NODE_SZ] + right[:NODE_SZ]).digest()


def bmtree_depth(leaf_cnt: int) -> int:
    """Layer count INCLUDING the root layer (fd_bmtree_depth): 1 for a
    single leaf, else 1 + ceil(log2(n))."""
    if leaf_cnt <= 1:
        return 1
    d = 0
    while (1 << d) < leaf_cnt:
        d += 1
    return d + 1


class MerkleTree20:
    """Full tree over 32-byte leaf hashes; root + per-leaf proofs."""

    def __init__(self, leaf_hashes: list):
        assert leaf_hashes
        self.layers = [list(leaf_hashes)]
        while len(self.layers[-1]) > 1:
            cur = self.layers[-1]
            nxt = [_merge(cur[i],
                          cur[i + 1] if i + 1 < len(cur) else cur[i])
                   for i in range(0, len(cur), 2)]
            self.layers.append(nxt)

    @classmethod
    def from_leaves(cls, leaf_blobs: list) -> "MerkleTree20":
        return cls([shred_merkle_leaf(b) for b in leaf_blobs])

    @classmethod
    def from_leaf_hashes(cls, hashes) -> "MerkleTree20":
        """hashes: (n, 32) uint8 array (e.g. device batched sha256)."""
        return cls([bytes(h) for h in hashes])

    @property
    def root(self) -> bytes:
        return self.layers[-1][0]

    @property
    def proof_len(self) -> int:
        return len(self.layers) - 1

    def proof(self, leaf_idx: int) -> list:
        """20-byte sibling nodes, leaf->root order
        (fd_bmtree_get_proof, fd_bmtree.c:327-345)."""
        out = []
        idx = leaf_idx
        for layer in self.layers[:-1]:
            sib = idx ^ 1
            if sib >= len(layer):
                sib = idx                  # odd layer: self-pair
            out.append(layer[sib][:NODE_SZ])
            idx >>= 1
        return out


def root_from_proof(leaf_hash: bytes, leaf_idx: int, proof: list) -> bytes:
    """Root implied by one leaf + inclusion proof
    (fd_bmtree_from_proof semantics, fd_bmtree.c:356-380)."""
    node = leaf_hash
    idx = leaf_idx
    for sib in proof:
        if idx & 1:
            node = _merge(sib, node)
        else:
            node = _merge(node, sib)
        idx >>= 1
    return node


def verify_proof(leaf_hash: bytes, leaf_idx: int, proof: list,
                 root: bytes) -> bool:
    return root_from_proof(leaf_hash, leaf_idx, proof) == root
