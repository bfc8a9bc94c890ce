"""Log2 latency histogram accumulator (copy of the part of the JAX
package's disco/metrics.py that the verify tile uses).

bucket i counts samples with ns in [2^i, 2^(i+1)) (bucket 0 takes 0/1
ns, bucket NBUCKETS-1 is the overflow tail)."""
from __future__ import annotations

import numpy as np

from ..runtime.tango import u64_snapshot

NBUCKETS = 32


def bucket_of(ns: int) -> int:
    """Log2 bucket index for a nanosecond sample."""
    if ns <= 1:
        return 0
    return min(NBUCKETS - 1, int(ns).bit_length() - 1)


class HistAccum:
    """Tile-local accumulator, flushed wholesale to shm (single writer,
    cumulative counts: readers never see decreasing values)."""

    def __init__(self):
        self.count = 0
        self.sum_ns = 0
        self.buckets = [0] * NBUCKETS

    def add(self, ns: int):
        self.count += 1
        self.sum_ns += ns
        self.buckets[bucket_of(ns)] += 1

    def seed_from(self, view_u64: np.ndarray):
        """Resume a cumulative series from its shm block, read in one
        snapshot (count is flushed last)."""
        snap = u64_snapshot(view_u64)
        self.count = int(snap[0])
        self.sum_ns = int(snap[1])
        self.buckets = [int(x) for x in snap[2:2 + NBUCKETS]]

    def flush_into(self, view_u64: np.ndarray):
        # count is written LAST: a racing reader never sees a count
        # exceeding the bucket sum
        view_u64[1] = self.sum_ns
        view_u64[2:2 + NBUCKETS] = self.buckets
        view_u64[0] = self.count
