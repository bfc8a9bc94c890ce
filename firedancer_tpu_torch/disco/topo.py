"""Declarative topology: workspaces, links, tiles, objects (copy of the
JAX package's disco/topo.py:64-639, cut to the main path).

`Topology` declares the graph; `build()` materializes every object into one
shared-memory workspace and returns a picklable `plan` dict of offsets,
the inter-process ABI. Tile processes receive (plan, tile_name), join
the workspace with create=False, and rebuild their rings, fseqs, cnc and
metric views from offsets alone (ref: src/disco/topo/fd_topo.h:36-662,
src/util/wksp/fd_wksp.h:27-47).

Reliability: a tile input declared reliable gets an fseq; the upstream
link's producer credit-gates on every reliable consumer's fseq
(ref: src/tango/fctl/fd_fctl.h:4-10). Unreliable consumers are never
waited on and must tolerate overruns.

Where the copy differs from the reference:
  * the workspace is named `/fdtt_<name>` (the reference's `/fdtpu_`,
    topo.py:256), so both packages' topologies can run side by side;
  * `Topology()` takes the [trace], [slo], [prof], [replay], [shed] and
    [funk] sections, none of the reference's snapshot, flight and tune
    (topo.py:85-126); app.config refuses those sections;
  * `tile` refuses, with NotImplementedError naming the ROADMAP.md
    queue-A item that ports it (disco/unported.py), every tile kind
    without an adapter here (the sign tile's keyswitch region,
    :460-465, with it), the per-tile args the port lacks and a chaos
    plan naming an action whose tile kind or seam is not ported (the
    reference ignores such an action); it refuses the verify tile's
    `device_fail_limit` by design (ROADMAP.md C: the port does not
    degrade to the CPU); a name that is no kind at all is left to fail
    in its tile process, as in the reference;
  * the plan carries no tune or keyswitch regions, and TileCtx has no
    knob handle. With [funk] backend "shm" the build carves the account
    store (runtime.Store) into the workspace and puts its offset and
    heap size on plan["funk"], as the reference does (topo.py:313-326);
    adapters join it through TileCtx's `plan` and `wksp`.

As in the reference, `sharded_tile(..., cpu0=)` gives shard i
`cpu_idx = cpu0 + i` (the launcher pins it); the [slo] targets resolve
against the built plan's tiles, metric slots and links (disco/slo.py);
the [prof] section is normalized and each profiled tile gets a
ProfRegion (prof/recorder.py) with its `prof_*` plan keys, and
TileCtx.prof is its region (None when unprofiled). Each tile's plan
entry names its adapter's GAUGES and DEVICE_SERIES slots
(`metrics_gauges`, `metrics_device`) for the prometheus renderer.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..funk.shmfunk import normalize_funk
from ..prof import ProfRegion, effective_prof, normalize_prof, region_for
from ..runtime import Workspace, Ring, Fseq, Cnc, Store, Tcache, TraceRing
from ..trace import effective_trace, normalize_trace, writer_for
from . import tiles as tiles_mod
from .metrics import HIST_REGION_U64, LINK_CONS_U64, LINK_PROD_U64
from .shed import normalize_shed
from .slo import normalize_slo, resolve_slo
from .supervise import SUP_SLOT_MIN, normalize_policy
from .unported import (REFUSED_TILE_ARGS, UNPORTED_CHAOS_ACTIONS,
                       UNPORTED_KINDS, UNPORTED_TILE_ARGS, refuse,
                       refuse_by_design)

METRICS_SLOTS = 64          # u64 counters per tile

# fdtpu_tile_<name> families the renderer already emits; a promoted
# device series may not shadow them (checked at build)
_RESERVED_TILE_FAMILIES = ("metric", "gauge", "liveness_seconds",
                           "tpu_seconds")


@dataclass
class LinkSpec:
    name: str
    depth: int
    mtu: int
    external: bool = False        # producer/consumer outside the topo


@dataclass
class TileSpec:
    name: str
    kind: str
    ins: list[dict] = field(default_factory=list)   # {link, reliable}
    outs: list[str] = field(default_factory=list)
    args: dict = field(default_factory=dict)


class Topology:
    """Declare links/tiles/objects, then build() into a wksp."""

    def __init__(self, name: str, wksp_size: int = 1 << 26,
                 trace: dict | None = None, replay: dict | None = None,
                 shed: dict | None = None, funk: dict | None = None,
                 slo: dict | None = None, prof: dict | None = None):
        self.name = name
        self.wksp_size = wksp_size
        # [trace] flight-recorder config (trace/recorder.py schema);
        # validated at build so a typo fails before launch
        self.trace = trace
        # [slo] objectives (disco/slo.py schema); targets resolve
        # against the declared tiles, metrics and links at build
        self.slo = slo
        # [prof] continuous-profiler config (prof/recorder.py schema)
        self.prof = prof
        # the [replay] section (tiles/replay.py's schema), validated at
        # build and carried on the plan for the replay tile
        self.replay = replay
        # [shed] front-door policing defaults (disco/shed.py schema);
        # ingest tiles resolve their effective gate from this + their
        # own `shed` override at adapter construction
        self.shed = shed
        # [funk] account-store config (funk/shmfunk.py schema); backend
        # "shm" makes build() carve the record/txn store into the wksp
        # so bank + the resolv/exec tile family share one fork tree
        self.funk = funk
        self.links: dict[str, LinkSpec] = {}
        self.tiles: dict[str, TileSpec] = {}
        self.tcaches: dict[str, int] = {}           # name -> depth

    def link(self, name: str, depth: int = 128, mtu: int = 1280,
             external: bool = False):
        if name in self.links:
            raise ValueError(f"duplicate link {name}")
        self.links[name] = LinkSpec(name, depth, mtu, external)
        return self

    def tile(self, name: str, kind: str, ins=(), outs=(), **args):
        """ins: link names (reliable) or (link, False) for unreliable."""
        if name in self.tiles:
            raise ValueError(f"duplicate tile {name}")
        if kind in UNPORTED_KINDS:
            refuse(f"tile kind {kind!r}", UNPORTED_KINDS[kind])
        for key, item in UNPORTED_TILE_ARGS.items():
            if key in args:
                refuse(f"the tile arg {key!r}", item)
        for key, why in REFUSED_TILE_ARGS.items():
            if key in args:
                refuse_by_design(f"the tile arg {key!r}", why)
        chaos = args.get("chaos")
        for ev in chaos.get("events", ()) if isinstance(chaos, dict) else ():
            item = UNPORTED_CHAOS_ACTIONS.get(ev.get("action"))
            if item is not None:
                refuse(f"the chaos action {ev['action']!r}", item)
        norm = []
        for i in ins:
            if isinstance(i, str):
                norm.append({"link": i, "reliable": True})
            else:
                norm.append({"link": i[0], "reliable": bool(i[1])})
        self.tiles[name] = TileSpec(name, kind, norm, list(outs), args)
        return self

    def tcache(self, name: str, depth: int = 4096):
        self.tcaches[name] = depth
        return self

    def sharded_tile(self, name: str, kind: str, cnt: int, ins=(),
                     outs=(), cpu0: int | None = None, **args):
        """Round-robin scale-out (the reference's multi-verify-tile
        layout, fd_verify_tile.c:49-53): `cnt` shards of one consumer
        kind. Shard i becomes tile f"{name}{i}" with rr_cnt=cnt /
        rr_idx=i, consuming the SAME in links (frag ownership is disjoint
        by seq % cnt) and producing outs[i]: one out link per shard,
        since links are SPMC; the downstream stage fans in. A
        list-valued `tcache`, `chaos` or `supervise` of length cnt
        distributes one per shard (a None entry: not on this shard, how a
        drill targets one shard); every other arg is shared. cpu0 pins
        shard i to core cpu0 + i (the launcher's cpu_idx, taken modulo
        the cores the process may run on).

        Per-shard in links (the exec tile family): an `ins` entry that is
        itself a list of cnt link names distributes one link per shard —
        shard i consumes entry[i] instead of the shared link. This is how
        an upstream ROUTING producer (the bank's conflict-group dispatch)
        addresses a specific shard. The (link, reliable) tuple form stays
        shared — a distribution entry is all-strings of length cnt."""
        cnt = int(cnt)
        if cnt < 1:
            raise ValueError(f"sharded tile {name}: cnt {cnt} < 1")
        outs = list(outs)
        if len(outs) != cnt:
            raise ValueError(
                f"sharded tile {name}: need one out link per shard "
                f"({cnt}), got {outs}")

        def _shard_ins(i):
            out = []
            for e in ins:
                if isinstance(e, (list, tuple)) and len(e) > 0 \
                        and all(isinstance(x, str) for x in e):
                    if len(e) != cnt:
                        raise ValueError(
                            f"sharded tile {name}: per-shard ins "
                            f"entry needs one link per shard ({cnt}),"
                            f" got {list(e)}")
                    out.append(e[i])
                else:
                    out.append(e)
            return out

        for i in range(cnt):
            a = {}
            for k, v in args.items():
                if isinstance(v, (list, tuple)) and len(v) == cnt \
                        and k in ("tcache", "chaos", "supervise"):
                    if v[i] is not None:
                        a[k] = v[i]
                else:
                    a[k] = v
            a["rr_cnt"] = cnt
            a["rr_idx"] = i
            if cpu0 is not None:
                a["cpu_idx"] = int(cpu0) + i
            self.tile(f"{name}{i}", kind, ins=_shard_ins(i),
                      outs=[outs[i]], **a)
        return self

    def _validate(self):
        producers: dict[str, str] = {}
        consumed: set[str] = set()
        for t in self.tiles.values():
            for ln in t.outs:
                if ln not in self.links:
                    raise ValueError(f"tile {t.name}: unknown out link {ln}")
                if ln in producers:
                    raise ValueError(
                        f"link {ln} has two producers "
                        f"({producers[ln]}, {t.name}) — links are SPMC")
                producers[ln] = t.name
            for i in t.ins:
                if i["link"] not in self.links:
                    raise ValueError(
                        f"tile {t.name}: unknown in link {i['link']}")
                consumed.add(i["link"])
        for ln, spec in self.links.items():
            if ln not in producers and not spec.external:
                raise ValueError(f"link {ln} has no producer")
            if ln not in consumed and not spec.external:
                raise ValueError(f"link {ln} has no consumer")

    def build(self, wksp_name: str | None = None) -> dict:
        """Materialize into a fresh workspace; return the picklable plan.

        The caller is the single creator (replace mode); every tile
        process joins with create=False."""
        self._validate()
        from ..tiles.replay import normalize_replay
        replay = normalize_replay(self.replay) \
            if self.replay is not None else None
        trace_cfg = normalize_trace(self.trace)
        unknown = set(trace_cfg["tiles"] or ()) - set(self.tiles)
        if unknown:
            raise ValueError(
                f"trace.tiles names unknown tile(s) {sorted(unknown)}")
        # [shed] policing defaults and the per-tile overrides: validated
        # before launch (the reference's topo.py:306-312, :367-368)
        shed = normalize_shed(self.shed) if self.shed is not None else None
        funk = normalize_funk(self.funk)
        for t in self.tiles.values():
            if "shed" in t.args:
                normalize_shed(t.args["shed"], per_tile=True)
        # [prof]: profiled tiles get a region and their prof_* keys, an
        # unprofiled one neither, so its TileCtx.prof stays None
        prof_cfg = normalize_prof(self.prof)
        for key in ("tiles", "breach_capture"):
            unknown = set(prof_cfg[key] or ()) - set(self.tiles)
            if unknown:
                raise ValueError(f"prof.{key} names unknown tile(s) "
                                 f"{sorted(unknown)}")
        slo_cfg = normalize_slo(self.slo)
        wksp_name = wksp_name or f"/fdtt_{self.name}"
        w = Workspace(wksp_name, self.wksp_size)
        plan: dict = {
            "topology": self.name,
            "wksp": {"name": wksp_name, "size": self.wksp_size},
            # per-boot seed shared by verify (tag computation) and dedup
            "seed": os.urandom(16).hex(),
            "links": {}, "fseqs": {}, "tcaches": {}, "tiles": {},
            "trace": trace_cfg, "replay": replay, "shed": shed,
            "funk": funk, "prof": prof_cfg,
        }

        def zeroed(nbytes: int) -> int:
            off = w.alloc(nbytes)
            w.view(off, nbytes)[:] = 0
            return off
        try:
            for ln, spec in self.links.items():
                r = Ring.create(w, depth=spec.depth, mtu=spec.mtu)
                plan["links"][ln] = {
                    "ring_off": r.off, "arena_off": r.arena_off,
                    "depth": spec.depth, "mtu": r.mtu,
                    # producer telemetry block (single writer: the one
                    # producing tile's stem)
                    "prod_metrics_off": zeroed(LINK_PROD_U64 * 8),
                }
            for name, depth in self.tcaches.items():
                tc = Tcache(w, depth=depth)
                plan["tcaches"][name] = {"off": tc.off, "depth": depth}
            # [funk] shm account store: offsets on the plan are the ABI;
            # the bank, resolv and exec tiles join it through
            # runtime.Store at plan["funk"]["off"]
            fk = plan["funk"]
            if fk["backend"] == "shm":
                heap_sz = fk["heap_mb"] << 20
                st = Store(w, rec_max=fk["rec_max"], txn_max=fk["txn_max"],
                           heap_sz=heap_sz)
                fk["off"], fk["heap_sz"] = st.off, heap_sz
            for tn, t in self.tiles.items():
                for i in t.ins:
                    if i["reliable"]:
                        plan["fseqs"][f"{i['link']}:{tn}"] = Fseq(w).off
                cnc = Cnc(w)
                cls = tiles_mod.REGISTRY.get(t.kind)
                names = list(getattr(cls, "METRICS", []))
                if len(names) > SUP_SLOT_MIN:
                    raise ValueError(
                        f"tile kind {t.kind}: {len(names)} metric slots "
                        f"collide with supervisor slots (max "
                        f"{SUP_SLOT_MIN})")
                plan["tiles"][tn] = {
                    "kind": t.kind,
                    "ins": list(t.ins),
                    "outs": list(t.outs),
                    "args": dict(t.args),
                    # per-(consumer, in-link) telemetry block, fed by
                    # this tile's stem; readers match by (tile, link)
                    "link_metrics": {i["link"]: zeroed(LINK_CONS_U64 * 8)
                                     for i in t.ins},
                    "supervise": normalize_policy(t.args.get("supervise")),
                    "cnc_off": cnc.off,
                    "metrics_off": zeroed(METRICS_SLOTS * 8),
                    "hist_off": zeroed(HIST_REGION_U64 * 8),
                    "hist_u64": HIST_REGION_U64,
                    # explicit slot-name ABI: readers match by name
                    "metrics_names": names,
                    # declared, never inferred from names: the
                    # prometheus series type and the promoted families
                    "metrics_gauges": list(getattr(cls, "GAUGES", [])),
                    "metrics_device": list(getattr(cls, "DEVICE_SERIES",
                                                   [])),
                }
                for nm in plan["tiles"][tn]["metrics_device"]:
                    if nm not in names:
                        raise ValueError(
                            f"tile kind {t.kind}: DEVICE_SERIES {nm!r} is "
                            f"not a declared metric slot")
                    if nm in _RESERVED_TILE_FAMILIES:
                        raise ValueError(
                            f"tile kind {t.kind}: DEVICE_SERIES {nm!r} "
                            f"would shadow the built-in fdtpu_tile_{nm} "
                            f"family")
                # flight-recorder ring, carved next to the metric slots;
                # an untraced tile gets no region and no plan keys, so
                # its TileCtx.trace stays None
                eff = effective_trace(
                    trace_cfg, tn,
                    normalize_trace(t.args.get("trace"), per_tile=True))
                if eff is not None:
                    plan["tiles"][tn].update(
                        trace_off=TraceRing.create(w, eff["depth"]).off,
                        trace_depth=eff["depth"],
                        trace_sample=eff["sample"])
                # profile region: folded-stack table, sample ring and
                # capture doorbell, for profiled tiles only
                peff = effective_prof(
                    prof_cfg, tn,
                    normalize_prof(t.args.get("prof"), per_tile=True))
                if peff is not None:
                    plan["tiles"][tn].update(
                        prof_off=ProfRegion.create(
                            w, peff["slots"], peff["ring"]).off,
                        prof_slots=peff["slots"], prof_ring=peff["ring"],
                        prof_hz=peff["hz"],
                        prof_stack_depth=peff["stack_depth"])
            # [slo]: every target resolves against what this plan
            # declares, so a dangling objective fails the build, not the
            # metric tile's first pass
            resolve_slo(slo_cfg, plan)
            plan["slo"] = slo_cfg
        except Exception:
            w.close()
            w.unlink()
            raise
        w.close()
        return plan


# ---------------------------------------------------------------------------
# plan-side join helpers (used inside tile processes and by the monitor)
# ---------------------------------------------------------------------------

class TileCtx:
    """A tile process's view of the plan: joined workspace, in/out rings,
    fseqs (own consumer fseqs + downstream reliable fseqs for each out
    link), tcaches, cnc, metric and per-link telemetry views, the flight
    recorder's writer (`trace`, None on an untraced tile: the whole
    disabled path) and the profile region (`prof`, None when
    unprofiled)."""

    def __init__(self, plan: dict, tile_name: str):
        self.plan, self.tile_name = plan, tile_name
        self.spec = plan["tiles"][tile_name]
        self.wksp = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                              create=False)
        self.cnc = Cnc(self.wksp, off=self.spec["cnc_off"])
        self.metrics_off = self.spec["metrics_off"]

        def ring(ln):
            li = plan["links"][ln]
            return Ring(self.wksp, li["ring_off"], li["depth"],
                        li["arena_off"], li["mtu"])

        self.in_rings = {}
        self.in_fseqs = {}
        for i in self.spec["ins"]:
            ln = i["link"]
            self.in_rings[ln] = ring(ln)
            key = f"{ln}:{tile_name}"
            if i["reliable"] and key in plan["fseqs"]:
                self.in_fseqs[ln] = Fseq(self.wksp, off=plan["fseqs"][key])

        # ring rejoin: a RESTARTED consumer attaches at each producer's
        # current seq instead of replaying from 0 (the supervisor sets
        # rejoin_at_tail on the respawn plan); publishing the fseq here
        # also clears the STALE sentinel
        rejoin = bool(self.spec.get("rejoin_at_tail"))
        self.in_seq0 = {}
        for ln, r in self.in_rings.items():
            self.in_seq0[ln] = int(r.seq) if rejoin else 0
            fs = self.in_fseqs.get(ln)
            if fs is not None and rejoin:
                fs.update(self.in_seq0[ln])

        self.out_rings = {}
        self.out_fseqs = {}
        for ln in self.spec["outs"]:
            self.out_rings[ln] = ring(ln)
            self.out_fseqs[ln] = [
                Fseq(self.wksp, off=off)
                for key, off in plan["fseqs"].items()
                if key.split(":", 1)[0] == ln]

        self.tcaches = {
            name: Tcache(self.wksp, depth=tc["depth"], off=tc["off"])
            for name, tc in plan["tcaches"].items()
        }
        self.trace = writer_for(plan, self.wksp, tile_name)
        # continuous profiler: None unless build carved a region for
        # this tile (the stem starts a sampler only then)
        self.prof = region_for(plan, self.wksp, tile_name)

        # per-link telemetry views: consumer blocks for the in links,
        # producer blocks for the out links, flushed by the stem
        self.link_cons_views = {
            ln: self.wksp.view(off, LINK_CONS_U64 * 8).view(np.uint64)
            for ln, off in self.spec["link_metrics"].items()
        }
        self.link_prod_views = {
            ln: self.wksp.view(plan["links"][ln]["prod_metrics_off"],
                               LINK_PROD_U64 * 8).view(np.uint64)
            for ln in self.spec["outs"]
        }
        # restart continuity: the stem flushes the Ring counters
        # wholesale, so a respawned tile seeds them from shm (a fresh
        # boot seeds zeros)
        for ln, view in self.link_cons_views.items():
            r = self.in_rings[ln]
            r.m_consumed, r.m_bytes, r.m_overruns = (int(x)
                                                     for x in view[:3])
        for ln, view in self.link_prod_views.items():
            r = self.out_rings[ln]
            r.m_pub, r.m_pub_bytes, r.m_backpressure = (int(x)
                                                        for x in view[:3])

    def in_seqs0(self) -> dict[str, int]:
        """Initial consume cursor per in link: 0 on a fresh boot, the
        producer's current seq on a supervised restart (ring rejoin)."""
        return dict(self.in_seq0)

    def metrics_view(self):
        return self.wksp.view(self.metrics_off, METRICS_SLOTS * 8) \
            .view(np.uint64)

    def hist_view(self):
        """u64 view of this tile's wait/work/tpu histogram region."""
        return self.wksp.view(self.spec["hist_off"],
                              HIST_REGION_U64 * 8).view(np.uint64)

    def close(self):
        self.wksp.close()


def read_metrics(wksp: Workspace, plan: dict, tile_name: str):
    off = plan["tiles"][tile_name]["metrics_off"]
    return wksp.view(off, METRICS_SLOTS * 8).view(np.uint64).copy()


def read_heartbeat(wksp: Workspace, plan: dict, tile_name: str) -> int:
    cnc = Cnc(wksp, off=plan["tiles"][tile_name]["cnc_off"])
    return cnc.last_heartbeat


def now_ticks() -> int:
    # ONE clock for heartbeats and watchdog staleness (utils/tempo
    # monotonic_ns == native fdtpu_ticks)
    from ..utils.tempo import monotonic_ns
    return monotonic_ns()
