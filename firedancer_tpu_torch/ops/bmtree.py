"""Solana binary Merkle tree (bmtree): batched roots on the SHA-256
kernel, and the host oracle (counterpart of the JAX package's
ops/bmtree.py:29-112).

Reference semantics (ref: src/ballet/bmtree/fd_bmtree.h:1-140):
  * leaf node  = sha256(leaf prefix ‖ leaf blob)
  * branch     = sha256(node prefix ‖ left ‖ right)
  * odd layer: the last node is paired with ITSELF (duplicated link)
  * short prefixes are the single bytes 0x00/0x01; the long 26-byte
    "\\x00SOLANA_MERKLE_SHREDS_LEAF" / "\\x01...NODE" prefixes are used
    for shreds (fd_bmtree.h:139-142)

Each level of `bmtree_root` is one batched SHA-256 over every node pair
of every tree (ops/cuda_sha256.sha256: the kernel on the card, its plain
version on the CPU), so a tree of max_leaves leaves costs
1 + log2(max_leaves) launches.
"""
from __future__ import annotations

import hashlib

import torch

from .. import device as _device
from . import cuda_sha256

__all__ = ["bmtree_root", "bmtree_depth", "host_bmtree_root",
           "LEAF_PREFIX", "NODE_PREFIX", "LEAF_PREFIX_SHREDS",
           "NODE_PREFIX_SHREDS"]

LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"
LEAF_PREFIX_SHREDS = b"\x00SOLANA_MERKLE_SHREDS_LEAF"
NODE_PREFIX_SHREDS = b"\x01SOLANA_MERKLE_SHREDS_NODE"


def bmtree_depth(n_leaves: int) -> int:
    """Number of reduction levels for n leaves."""
    d = 0
    while (1 << d) < n_leaves:
        d += 1
    return d


def _hash_rows(prefix: bytes, parts, dev) -> torch.Tensor:
    """sha256(prefix ‖ parts...) of every row: parts (..., k) uint8 with
    one leading shape -> (..., 32) uint8, as one launch over the rows."""
    lead = parts[0].shape[:-1]
    pre = torch.tensor(list(prefix), dtype=torch.uint8, device=dev)
    msg = torch.cat([pre.expand(*lead, len(prefix)), *parts], dim=-1)
    msg = msg.reshape(-1, msg.shape[-1]).contiguous()
    ln = torch.full((msg.shape[0],), msg.shape[1], dtype=torch.int32,
                    device=dev)
    return cuda_sha256.sha256(msg, ln).reshape(*lead, 32)


def bmtree_root(leaves, leaf_cnt, max_leaves: int,
                leaf_prefix: bytes = LEAF_PREFIX,
                node_prefix: bytes = NODE_PREFIX, device="cuda"):
    """Root of a bmtree over a variable leaf count, batched.

    leaves (..., max_leaves, 32) uint8 — 32-byte leaf blobs;
    leaf_cnt (...,) int32 in [1, max_leaves]; max_leaves a power of two;
    numpy arrays or tensors -> (..., 32) uint8 roots on `device`.

    The reference's topology exactly: each level pairs (2i, 2i+1), the
    last node of an odd level with itself; nodes past the live count,
    and a level of one node, pass through."""
    assert max_leaves & (max_leaves - 1) == 0, "max_leaves power of two"
    dev = _device.resolve(device)
    leaves = torch.as_tensor(leaves, dtype=torch.uint8, device=dev)
    live = torch.as_tensor(leaf_cnt, dtype=torch.int64, device=dev)
    nodes = _hash_rows(leaf_prefix, [leaves], dev)   # (..., max_leaves, 32)
    for _ in range(bmtree_depth(max_leaves)):
        left, right = nodes[..., 0::2, :], nodes[..., 1::2, :]
        idx = torch.arange(left.shape[-2], device=dev)
        live_e = live.unsqueeze(-1)
        right = torch.where(((2 * idx + 1) < live_e).unsqueeze(-1), right,
                            left)
        parents = _hash_rows(node_prefix, [left, right], dev)
        passthru = ((2 * idx) >= live_e) | (live_e == 1)
        nodes = torch.where(passthru.unsqueeze(-1), left, parents)
        live = torch.clamp((live + 1) // 2, min=1)
    return nodes[..., 0, :]


def host_bmtree_root(leaf_blobs: list[bytes],
                     leaf_prefix: bytes = LEAF_PREFIX,
                     node_prefix: bytes = NODE_PREFIX) -> bytes:
    """Plain-python reference implementation of the same topology."""
    assert leaf_blobs
    nodes = [hashlib.sha256(leaf_prefix + b).digest() for b in leaf_blobs]
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes), 2):
            l = nodes[i]
            r = nodes[i + 1] if i + 1 < len(nodes) else nodes[i]
            nxt.append(hashlib.sha256(node_prefix + l + r).digest())
        nodes = nxt
    return nodes[0]
