"""Shred path: wire format, FEC-set merkle commitment, shredder, the
turbine destination tree, and the follower's FEC resolver, store and
reassembler (the port's copy of the JAX package's shred/).

Entry batches are split into 1203-byte merkle data shreds,
Reed-Solomon-extended with 1228-byte parity shreds, committed to with a
20-byte-node SHA-256 merkle tree whose root the leader signs, and
(optionally) chained root-to-root across FEC sets.
"""
from .fec_resolver import CompletedFec, FecResolver
from .format import (DataShred, CodeShred, parse_shred, SHRED_MAX_SZ,
                     SHRED_MIN_SZ)
from .merkle import MerkleTree20, shred_merkle_leaf
from .shred_dest import ClusterNode, ShredDest
from .store import FecStore, Reassembler, Slice
from .shredder import Shredder, FecSet, count_fec_sets, count_data_shreds, \
    count_parity_shreds

__all__ = ["DataShred", "CodeShred", "parse_shred", "SHRED_MAX_SZ",
           "SHRED_MIN_SZ", "MerkleTree20", "shred_merkle_leaf",
           "Shredder", "FecSet", "count_fec_sets", "count_data_shreds",
           "count_parity_shreds", "FecResolver", "CompletedFec",
           "ClusterNode", "ShredDest", "FecStore", "Reassembler",
           "Slice"]
