"""fdflight recorder engine: drain the shm observability plane into
the archive, seal incident bundles around SLO breaches (copy of the JAX
package's flight/recorder.py; the black boxes it bundles follow the
port's prefix, trace/export.blackbox_path).

Reader-side only — the fdmetrics contract the metric tile pioneered:
every sample is a read of shm regions other tiles already maintain
(metric slots, link telemetry blocks, stem histograms, trace rings,
prof sample rings, the SLO engine's breach dumps), so the writer tiles
pay NOTHING for the archive's existence. The FlightAdapter
(disco/tiles.py) calls `maybe_drain()` from its housekeeping hook; the
`hz` cadence is enforced here, not by the stem.

Counters vs gauges: counter slots archive as DELTAS against the
previous sample (sum over a window == the /metrics counter delta over
the same window, exactly — the fdflight query-equivalence contract),
gauges archive as levels (aux bit 0 set). The first sample after boot
deltas against zero, so a whole-history sum equals the live counter.

Incidents: the recorder watches the metric tile's `slo_breaches`
counter and the per-target breach dumps (disco/slo.py slo_dump_path —
the same doorbell surface fdprof's breach_capture rides). A breach
opens a pending incident; after `incident_window_s` more seconds of
frames the bundle is sealed ATOMICALLY (tmp+rename) next to the
segments: the +/-window frame slice, the breached target's dump, the
saturating-hop attribution, any supervisor black boxes, and a
chrome-trace export of the trace rings — self-contained, so
`python -m firedancer_tpu_torch.flight DIR --incident` can replay it
after every tile (recorder included) is SIGKILLed and the workspace is
gone.
"""
from __future__ import annotations

import glob
import json
import os
from collections import deque

from ..utils.tempo import monotonic_ns
from . import effective_sources, normalize_flight
from .archive import (ArchiveWriter, saturating_hop, write_atomic_json)
from .codec import (KIND_HIST, KIND_LINK, KIND_MARK,
                    KIND_METRIC, KIND_PROF, KIND_SLO, KIND_TRACE,
                    decode_frames)

# trace events worth archiving at full rate even when sampled: the
# lifecycle/fault vocabulary a post-mortem actually greps for (bulk
# wait/work/consume spans stay shm-only — the archive is history, not
# a second trace ring)
_TRACE_KEEP = ("boot", "halt", "fail", "chaos", "watchdog", "restart",
               "down", "slo", "cpu_fallback", "compile", "tune")


class FlightRecorder:
    def __init__(self, plan: dict, wksp, cfg: dict | None = None,
                 clock=monotonic_ns):
        self.plan, self.wksp = plan, wksp
        self.cfg = normalize_flight(cfg if cfg is not None
                                    else plan.get("flight"))
        self.clock = clock
        self.sources = effective_sources(self.cfg)
        self.node_id = self.cfg["node_id"]
        self.topology = plan.get("topology", "?")
        self.writer = ArchiveWriter(
            self.cfg["dir"], segment_mb=self.cfg["segment_mb"],
            retain_mb=self.cfg["retain_mb"], node_id=self.node_id)
        self._interval_ns = int(1e9 / self.cfg["hz"])
        self._window_ns = int(self.cfg["incident_window_s"] * 1e9)
        self._next_ns = 0
        self._last_metrics: dict[str, list[int]] = {}
        self._last_hists: dict[str, dict[str, int]] = {}
        self._last_links: dict[str, dict[str, int]] = {}
        self._trace_cursor: dict[str, int] = {}
        self._last_prof: dict[str, dict[str, int]] = {}
        self._slo_seen: dict[str, int] = {}     # target -> dumped_at_ns
        self._pending: list[dict] = []
        # in-memory tail for the incident pre-window: raw frame bytes,
        # pruned by timestamp (bounded by 2x window at the drain rate)
        self._tail: deque[tuple[int, bytes]] = deque()
        self.metrics = {"frames": 0, "drains": 0, "incidents": 0,
                        "segments": 0, "bytes": 0}
        ts = self.clock()
        self._emit(KIND_MARK, ts, self.topology, "boot", os.getpid())
        self.writer.flush()

    # -- frame plumbing -----------------------------------------------------

    def _emit(self, kind: int, ts: int, source: str, name: str,
              value: int, aux: int = 0):
        frame = self.writer.append(kind, ts, source, name, value, aux)
        if self._window_ns:
            self._tail.append((ts, frame))

    def _prune_tail(self, now: int):
        horizon = now - 2 * self._window_ns
        while self._tail and self._tail[0][0] < horizon:
            self._tail.popleft()

    # -- sample passes ------------------------------------------------------

    def _drain_metrics(self, ts: int):
        from ..disco.topo import read_metrics
        for tn, spec in self.plan["tiles"].items():
            names = spec.get("metrics_names") or []
            if not names:
                continue
            vals = read_metrics(self.wksp, self.plan, tn)
            gauges = set(spec.get("metrics_gauges")
                         or spec.get("gauges") or [])
            prev = self._last_metrics.get(tn)
            for i, nm in enumerate(names):
                v = int(vals[i])
                if nm in gauges:
                    if prev is None or int(prev[i]) != v:
                        self._emit(KIND_METRIC, ts, tn, nm, v, 1)
                else:
                    d = v - (int(prev[i]) if prev is not None else 0)
                    if d:
                        self._emit(KIND_METRIC, ts, tn, nm, d)
            self._last_metrics[tn] = vals
        self._drain_hists(ts)

    def _drain_hists(self, ts: int):
        from ..disco.metrics import quantile_ns, read_hists
        for tn in self.plan["tiles"]:
            hists = read_hists(self.wksp, self.plan, tn)
            if not hists:
                continue
            prev = self._last_hists.setdefault(tn, {})
            for hk, h in hists.items():
                d = int(h["sum_ns"]) - prev.get(hk, 0)
                if d:
                    self._emit(KIND_HIST, ts, tn, f"{hk}_sum_ns", d)
                prev[hk] = int(h["sum_ns"])
            work = hists.get("work")
            if work and work.get("count"):
                self._emit(KIND_HIST, ts, tn, "work_p99_ns",
                           int(quantile_ns(work, 0.99)), 1)

    def _drain_links(self, ts: int):
        from ..disco.metrics import (merge_hists, quantile_ns,
                                     read_link_metrics)
        for ln, rec in read_link_metrics(self.wksp, self.plan).items():
            prev = self._last_links.setdefault(ln, {})
            cons = rec.get("consumers") or {}
            cur = {
                "pub": int(rec.get("pub", 0)),
                "pub_bytes": int(rec.get("pub_bytes", 0)),
                "backpressure": int(rec.get("backpressure", 0)),
                "consumed": sum(int(c.get("consumed", 0))
                                for c in cons.values()),
                "overruns": sum(int(c.get("overruns", 0))
                                for c in cons.values()),
            }
            for nm, v in cur.items():
                d = v - prev.get(nm, 0)
                if d:
                    self._emit(KIND_LINK, ts, ln, nm, d)
                prev[nm] = v
            h = merge_hists(c["hist"] for c in cons.values()
                            if c.get("hist"))
            if h and h.get("count"):
                self._emit(KIND_LINK, ts, ln, "consume_p99_ns",
                           int(quantile_ns(h, 0.99)), 1)

    def _drain_trace(self, ts: int):
        from ..runtime.tango import TraceRing
        from ..trace.events import decode
        from ..trace.recorder import link_names
        lnames = link_names(self.plan)
        for tn, spec in self.plan["tiles"].items():
            off = spec.get("trace_off")
            if off is None:
                continue
            ring = TraceRing(self.wksp, off, int(spec["trace_depth"]))
            cur, recs, lost = ring.snapshot_since(
                self._trace_cursor.get(tn, 0))
            self._trace_cursor[tn] = cur
            for rec in recs:
                d = decode(rec, lnames)
                if d["ev"] not in _TRACE_KEEP:
                    continue
                aux = (d["etype"] & 0xFFFF) \
                    | (min(d["count"], 0xFFFF) << 16)
                self._emit(KIND_TRACE, d["ts"], tn, d["ev"],
                           d["arg"], aux)

    def _drain_prof(self, ts: int):
        from ..prof.export import read_folded
        try:
            folded = read_folded(self.plan, self.wksp)
        except Exception:
            return
        for tn, stacks in folded.items():
            prev = self._last_prof.setdefault(tn, {})
            for stack, states in stacks.items():
                total = sum(states.values())
                d = total - prev.get(stack, 0)
                if d:
                    leaf = stack.rsplit(";", 1)[-1]
                    self._emit(KIND_PROF, ts, tn, leaf, d)
                prev[stack] = total

    def _drain_slo(self, ts: int):
        from ..disco.slo import slo_dump_path
        targets = (self.plan.get("slo") or {}).get("target") or []
        for t in targets:
            name = t["name"]
            path = slo_dump_path(self.topology, name)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            stamp = int(doc.get("dumped_at_ns", 0))
            if stamp <= self._slo_seen.get(name, 0):
                continue
            self._slo_seen[name] = stamp
            kind = doc.get("kind", "breach")
            value = max(0, int(doc.get("value") or 0))
            self._emit(KIND_SLO, ts, name, kind, value,
                       int(doc.get("breaches", 0)))
            if kind == "breach":
                self._open_incident(ts, name, value, doc)

    # -- incidents ----------------------------------------------------------

    def _open_incident(self, ts: int, target: str, value: int,
                       dump: dict):
        self._pending.append({"ts": ts, "target": target,
                              "value": value, "dump": dump})
        self.metrics["incidents"] += 1

    def _seal_ready(self, now: int, force: bool = False):
        still = []
        for inc in self._pending:
            if force or now >= inc["ts"] + self._window_ns:
                self._seal(inc, now)
            else:
                still.append(inc)
        self._pending = still

    def _seal(self, inc: dict, now: int):
        t0 = inc["ts"] - self._window_ns
        t1 = inc["ts"] + self._window_ns
        raw = b"".join(fr for ts, fr in self._tail if t0 <= ts <= t1)
        frames, _ = decode_frames(raw)
        doc = {
            "topology": self.topology,
            "node_id": self.node_id,
            "target": inc["target"],
            "value": inc["value"],
            "breach_ts_ns": inc["ts"],
            "sealed_at_ns": now,
            "window_ns": [t0, t1],
            "slo_dump": inc["dump"],
            "saturating_hop": saturating_hop(frames),
            "frames": frames,
            "blackboxes": self._blackboxes(),
            "chrome": self._chrome(),
        }
        path = os.path.join(self.writer.dir,
                            f"incident-{inc['ts']}.json")
        try:
            write_atomic_json(path, doc)
        except OSError:
            return
        from ..utils import log
        log.warning(f"flight: sealed incident bundle {path} "
                    f"(target {inc['target']!r})")

    def _blackboxes(self) -> list[dict]:
        from ..trace.export import blackbox_path
        out = []
        for path in sorted(glob.glob(blackbox_path(self.topology, "*"))):
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
        return out

    def _chrome(self) -> dict | None:
        """Chrome-trace export of the live trace rings at seal time —
        embedded so the bundle exports to Perfetto with the shm long
        gone. None when the topology is untraced."""
        try:
            from ..trace import export as trace_export
            evs = trace_export.read_rings(self.plan, self.wksp)
            if not any(evs.values()):
                return None
            return trace_export.to_chrome(evs, self.topology)
        except Exception:
            return None

    # -- the housekeeping entry point --------------------------------------

    def maybe_drain(self) -> bool:
        """One rate-limited drain pass (the FlightAdapter housekeeping
        hook). Returns True when a pass ran."""
        now = self.clock()
        if now < self._next_ns:
            return False
        self._next_ns = now + self._interval_ns
        self.drain(now)
        return True

    def drain(self, now: int | None = None):
        now = self.clock() if now is None else now
        if "metrics" in self.sources:
            self._drain_metrics(now)
        if "links" in self.sources:
            self._drain_links(now)
        if "slo" in self.sources:
            self._drain_slo(now)
        if "trace" in self.sources:
            self._drain_trace(now)
        if "prof" in self.sources:
            self._drain_prof(now)
        self._seal_ready(now)
        self._prune_tail(now)
        self.writer.flush()
        self.metrics["drains"] += 1
        self.metrics["frames"] = self.writer.frames
        self.metrics["segments"] = self.writer.rotations + 1
        self.metrics["bytes"] = self.writer.bytes_written

    def close(self):
        """Final drain + halt mark + seal anything pending with the
        frames on hand (a truncated window beats a lost bundle)."""
        now = self.clock()
        self.drain(now)
        self._seal_ready(now, force=True)
        self._emit(KIND_MARK, now, self.topology, "halt", os.getpid())
        self.writer.close()
