"""Metrics: log2 latency histograms and per-link telemetry blocks (copy
of the JAX package's disco/metrics.py:30-220; its prometheus renderer
waits for the metric tile, ROADMAP.md queue A item 8).

Histogram region layout per tile (all u64, little-endian, single writer):

    [0] count   [1] sum_ns   [2..2+NBUCKETS) bucket counts

bucket i counts samples with ns in [2^i, 2^(i+1)) (bucket 0 takes 0/1
ns, bucket NBUCKETS-1 is the overflow tail). Three histograms per tile:
WAIT (poll_once returned 0), WORK (frags were processed) and TPU (the
verify tile's device dispatch + verdict readback, its `tpu_hist`; zero
for host-only tiles).

Per-link telemetry: every link has a PRODUCER block (written only by
the producing tile's stem; links are SPMC) and every (consumer tile, in
link) pair a CONSUMER block with a consume-latency histogram, so any
reader can compute per-hop loss (published - consumed):

    producer block (u64): [0] pub  [1] pub_bytes  [2] backpressure
    consumer block (u64): [0] consumed [1] bytes [2] overruns
                          [3..3+HIST_U64) consume-latency histogram
"""
from __future__ import annotations

import numpy as np

from ..runtime.tango import u64_snapshot

NBUCKETS = 32
HIST_U64 = 2 + NBUCKETS          # count, sum_ns, buckets
HIST_KINDS = ("wait", "work", "tpu")   # order fixes the shm layout
HIST_REGION_U64 = HIST_U64 * len(HIST_KINDS)

LINK_PROD_COUNTERS = ("pub", "pub_bytes", "backpressure")
LINK_CONS_COUNTERS = ("consumed", "bytes", "overruns")
LINK_PROD_U64 = len(LINK_PROD_COUNTERS)
LINK_CONS_U64 = len(LINK_CONS_COUNTERS) + HIST_U64


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


def _hist_from_raw(h: np.ndarray) -> dict:
    return {"count": int(h[0]), "sum_ns": int(h[1]),
            "buckets": [int(x) for x in h[2:2 + NBUCKETS]]}


def read_hists(wksp, plan: dict, tile_name: str) -> dict:
    """{kind: {count, sum_ns, buckets[NBUCKETS]}} from shm."""
    off = plan["tiles"][tile_name]["hist_off"]
    raw = wksp.view(off, HIST_REGION_U64 * 8).view(np.uint64).copy()
    return {kind: _hist_from_raw(raw[k * HIST_U64:(k + 1) * HIST_U64])
            for k, kind in enumerate(HIST_KINDS)}


def link_lag(rec: dict, consumer: str) -> int:
    """Per-hop loss for one consumer of a read_link_metrics record:
    frags published but never consumed by it, clamped at 0."""
    return max(0, rec["pub"] - rec["consumers"][consumer]["consumed"])


def merge_hists(hists) -> dict | None:
    """Bucketwise sum of log2 histogram dicts (None if all empty), e.g.
    one link-level quantile over rr-sharded consumers."""
    hs = [h for h in hists if h["count"]]
    if not hs:
        return None
    return {"count": sum(h["count"] for h in hs),
            "sum_ns": sum(h["sum_ns"] for h in hs),
            "buckets": [sum(b) for b in
                        zip(*(h["buckets"] for h in hs))]}


def link_producers(plan: dict) -> dict[str, str]:
    """link -> producing tile name (SPMC: at most one)."""
    out = {}
    for tn, spec in plan["tiles"].items():
        for ln in spec.get("outs", []):
            out[ln] = tn
    return out


def read_link_metrics(wksp, plan: dict, links=None) -> dict:
    """{link: {producer, pub, pub_bytes, backpressure,
    consumers: {tile: {consumed, bytes, overruns, hist}}}}: the whole
    per-link telemetry plane in one pass; `links` restricts to a
    subset."""
    producers = link_producers(plan)
    out: dict = {}
    for ln, li in plan["links"].items():
        if links is not None and ln not in links:
            continue
        off = li["prod_metrics_off"]
        raw = wksp.view(off, LINK_PROD_U64 * 8).view(np.uint64).copy()
        out[ln] = {"producer": producers.get(ln),
                   **{nm: int(raw[i])
                      for i, nm in enumerate(LINK_PROD_COUNTERS)},
                   "consumers": {}}
    for tn, spec in plan["tiles"].items():
        for ln, off in spec["link_metrics"].items():
            if links is not None and ln not in links:
                continue
            raw = wksp.view(off, LINK_CONS_U64 * 8).view(np.uint64) \
                .copy()
            rec = {nm: int(raw[i])
                   for i, nm in enumerate(LINK_CONS_COUNTERS)}
            rec["hist"] = _hist_from_raw(raw[len(LINK_CONS_COUNTERS):])
            out[ln]["consumers"][tn] = rec
    return out


def quantile_ns(hist: dict, q: float) -> int:
    """Upper-bound estimate of the q-quantile from log2 buckets: 0 for
    an empty histogram; q=0.0 is the minimum sample's bucket bound and
    q=1.0 the maximum's."""
    count = hist["count"]
    if not count:
        return 0
    target = q * count
    cum = 0
    for i, c in enumerate(hist["buckets"]):
        cum += c
        if cum >= target and cum > 0:
            return 1 << (i + 1)
    return 1 << NBUCKETS
