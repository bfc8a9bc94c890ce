"""Metrics: log2 latency histograms, per-link telemetry blocks and the
prometheus text the metric tile serves (copy of the JAX package's
disco/metrics.py; ref: src/disco/metrics/fd_metrics.h,
fd_prometheus.c).

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


# ---------------------------------------------------------------------------
# prometheus text rendering (ref: src/disco/metrics/fd_prometheus.c)
# ---------------------------------------------------------------------------

def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_hist(lines: list[str], base: str, lab: str, h: dict):
    """One histogram family in exposition format: cumulative buckets,
    folding the clamp/overflow bucket into +Inf, monotone even against
    a raced flush (count and buckets are written at distinct
    instants — the clamp below keeps the series consistent)."""
    cum = 0
    for i, c in enumerate(h["buckets"][:-1]):
        cum += c
        le = (1 << (i + 1)) / 1e9
        lines.append(f'{base}_bucket{{{lab},le="{le:g}"}} {cum}')
    total = max(h["count"], cum + h["buckets"][-1])
    lines.append(f'{base}_bucket{{{lab},le="+Inf"}} {total}')
    lines.append(f'{base}_sum{{{lab}}} {h["sum_ns"] / 1e9:g}')
    lines.append(f'{base}_count{{{lab}}} {total}')


def render_prometheus(plan: dict, wksp) -> str:
    """All tiles' named counters, wait/work/tpu histograms, liveness,
    per-link telemetry, and device (`tpu_*`) series, in prometheus text
    exposition format. Reader-side only (any process attached to the
    workspace can render)."""
    from ..runtime import Cnc, CNC_RUN
    from . import topo as topo_mod

    topo = _esc(plan.get("topology", "?"))
    lines = [
        "# TYPE fdtpu_tile_up gauge",
        "# TYPE fdtpu_heartbeat_age_ticks gauge",
        "# TYPE fdtpu_tile_metric counter",
        "# TYPE fdtpu_tile_gauge gauge",
    ]
    hist_lines: list[str] = []
    tpu_hist_lines: list[str] = []
    # DEVICE_SERIES-declared slots are the device-telemetry series:
    # promoted to their own family (fdtpu_tile_<name>) instead of the
    # generic name-labeled series, so dashboards get first-class
    # metric names (declaration rides the plan like GAUGES; topo.build
    # rejects names that would shadow a built-in family)
    tpu_series: dict[str, tuple[str, list[str]]] = {}
    now = topo_mod.now_ticks()
    for tn, spec in plan["tiles"].items():
        lab = f'topology="{topo}",tile="{_esc(tn)}",kind="{_esc(spec["kind"])}"'
        cnc = Cnc(wksp, off=spec["cnc_off"])
        up = 1 if cnc.state == CNC_RUN else 0
        lines.append(f"fdtpu_tile_up{{{lab}}} {up}")
        age = max(0, now - cnc.last_heartbeat)
        lines.append(f"fdtpu_heartbeat_age_ticks{{{lab}}} {age}")
        vals = topo_mod.read_metrics(wksp, plan, tn)
        gauges = set(spec.get("metrics_gauges", []))
        device = set(spec.get("metrics_device", []))
        for i, nm in enumerate(spec.get("metrics_names", [])):
            if i >= len(vals):
                break
            # adapters DECLARE their gauge slots (class GAUGES) and
            # device-series slots (class DEVICE_SERIES); the renderer
            # never infers types or families from names
            is_gauge = nm in gauges
            if nm in device:
                fam = f"fdtpu_tile_{nm}"
                typ, out = tpu_series.setdefault(
                    fam, ("gauge" if is_gauge else "counter", []))
                out.append(f'{fam}{{{lab}}} {int(vals[i])}')
                continue
            series = "fdtpu_tile_gauge" if is_gauge \
                else "fdtpu_tile_metric"
            lines.append(
                f'{series}{{{lab},name="{_esc(nm)}"}} {int(vals[i])}')
        # supervisor counters (restarts / watchdog trips / down gauge)
        # live in the region's top slots — same region, fixed indices
        from .supervise import SUP_GAUGES, sup_counters
        for nm, val in sup_counters(vals).items():
            series = "fdtpu_tile_gauge" if nm in SUP_GAUGES \
                else "fdtpu_tile_metric"
            lines.append(f'{series}{{{lab},name="{nm}"}} {val}')
        for kind, h in read_hists(wksp, plan, tn).items():
            if kind == "tpu":
                # device-time attribution: only tiles that actually
                # drive a device populate it — zero-count tiles stay
                # out of the exposition (no empty series per tile)
                if h["count"]:
                    _render_hist(tpu_hist_lines,
                                 "fdtpu_tile_tpu_seconds", lab, h)
                continue
            _render_hist(hist_lines, f"fdtpu_poll_{kind}_seconds",
                         lab, h)
    if hist_lines:
        lines.append("# TYPE fdtpu_poll_wait_seconds histogram")
        lines.append("# TYPE fdtpu_poll_work_seconds histogram")
        lines.extend(hist_lines)
    if tpu_hist_lines:
        lines.append("# TYPE fdtpu_tile_tpu_seconds histogram")
        lines.extend(tpu_hist_lines)
    for fam in sorted(tpu_series):
        typ, out = tpu_series[fam]
        lines.append(f"# TYPE {fam} {typ}")
        lines.extend(out)
    lines.extend(_render_links(plan, wksp, topo))
    return "\n".join(lines) + "\n"


def _render_links(plan: dict, wksp, topo: str) -> list[str]:
    """fdtpu_link_* per-link series, labeled link/producer/consumer —
    the per-hop half of the exposition (publish counters from the
    producer block, consume counters + latency histogram per consumer,
    and the derived lag gauge = published - consumed)."""
    links = read_link_metrics(wksp, plan)
    if not links:
        return []
    lines = [
        "# TYPE fdtpu_link_pub counter",
        "# TYPE fdtpu_link_pub_bytes counter",
        "# TYPE fdtpu_link_backpressure counter",
        "# TYPE fdtpu_link_consumed counter",
        "# TYPE fdtpu_link_bytes counter",
        "# TYPE fdtpu_link_overruns counter",
        "# TYPE fdtpu_link_lag gauge",
    ]
    hist_lines: list[str] = []
    for ln in sorted(links):
        rec = links[ln]
        prod = _esc(rec["producer"] or "external")
        plab = f'topology="{topo}",link="{_esc(ln)}",producer="{prod}"'
        for nm in LINK_PROD_COUNTERS:
            lines.append(f'fdtpu_link_{nm}{{{plab}}} {rec[nm]}')
        for tn in sorted(rec["consumers"]):
            c = rec["consumers"][tn]
            clab = f'{plab},consumer="{_esc(tn)}"'
            for nm in LINK_CONS_COUNTERS:
                lines.append(f'fdtpu_link_{nm}{{{clab}}} {c[nm]}')
            lines.append(f'fdtpu_link_lag{{{clab}}} '
                         f'{link_lag(rec, tn)}')
            if c["hist"]["count"]:
                _render_hist(hist_lines, "fdtpu_link_consume_seconds",
                             clab, c["hist"])
    if hist_lines:
        lines.append("# TYPE fdtpu_link_consume_seconds histogram")
        lines.extend(hist_lines)
    return lines
