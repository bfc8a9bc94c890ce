"""Layered TOML configuration -> topology (copy of the JAX package's
app/config.py:147-345).

TOML layers deep-merge (later layers win), and the merged document
declares the whole topology (links, tcaches, tiles with their args),
which `build_topology` turns into a declarative `Topology`
(disco/topo.py); ref: src/app/fdctl/config/default.toml,
src/app/shared/fd_config.h.

Schema (the reference's, cut to the kinds the port has):

    [topology]
    name = "demo"            # shm namespace (default: cfg + pid)
    wksp_size = 67108864

    [[link]]
    name = "ingest"
    depth = 8192             # frags (power of two)
    mtu = 1280

    [[tcache]]
    name = "verify_tc"
    depth = 8192

    [[tile]]
    name = "verify"
    kind = "verify"          # synth | verify | dedup | sink | pack |
                             # bank | poh | shred | sign | replay |
                             # sock | gossip | exec | resolv | metric |
                             # archiver | playback | snapld | snapdc |
                             # snapin
    ins = ["ingest"]
    outs = ["verify_dedup"]
    batch = 2048             # every other key = tile arg, verbatim
    # tile_cnt = 2           # rr-sharded scale-out: tiles verify0 and
    # outs = ["vd0", "vd1"]  #  verify1, one out link per shard;
    # tcache = ["tc0","tc1"] #  a list-valued tcache distributes one
                             #  per shard; an ins entry that is a
                             #  list of tile_cnt links gives one to
                             #  each shard (the exec tile family)

    [tile.supervise]         # per-tile restart policy (supervise.py)
    policy = "restart"       # "fail_fast" (default) | "restart"

    [topology.supervise]     # topology-wide defaults, deep-merged
    policy = "restart"       #  under each tile's table

    [trace]                  # fdtrace flight recorder (trace/recorder.py)
    enable = true            # default false: untraced tiles pay nothing
    depth = 2048             # records per tile ring (power of two)

    [tile.trace]             # per-tile override (opt out/in, depth,
    sample = 16              #  sample)

    [prof]                   # fdprof continuous profiler (prof/recorder.py)
    enable = true            # default false: unprofiled tiles pay one
    hz = 97                  #  attribute check, no sampler thread
    slots = 256              # folded-stack table entries (power of two)
    ring = 2048              # timestamped sample ring (power of two)
    tiles = ["verify"]       # optional allowlist (default: all tiles)
    capture_ms = 200.0       # device-trace window (torch.profiler)
    breach_capture = ["verify"]  # SLO breach -> device capture here

    [tile.prof]              # per-tile override (opt out/in, hz,
    hz = 29                  #  slots, ring, stack_depth)

    [slo]                    # service-level objectives (disco/slo.py),
    fast_window_s = 5.0      #  evaluated by the metric tile; breaches
    slow_window_s = 60.0     #  flip its slo_breach gauge, leave an
    burn_fast = 1.0          #  EV_SLO trace event, and dump next to
    burn_slow = 0.5          #  the supervisor black boxes

    [[slo.target]]           # one objective per table (merged by name
    name = "verify-latency"  #  across layers); expr grammar:
    expr = "verify.work p99 < 500us"   # <source> [agg] <op> <threshold>
                             #  sources: tile.metric, tile.wait|work|tpu,
                             #  link.<link>.<counter>

    cpu_idx = 3              # per tile: pin its process to that core
    cpu0 = 1                 # sharded: shard i pins to core cpu0 + i
    lazy_ns = 2000000        # per tile: the housekeeping interval, or
    lazy_auto = true         #  one derived from its out links' depth

    [[tile.chaos.events]]    # seeded fault plan (utils/chaos.py)
    action = "crash"
    at_rx = 32

    [shed]                   # front-door policing (disco/shed.py):
    rate_pps = 1000.0        #  per-peer token buckets, bounded peer
    max_peers = 4096         #  table, stake-weighted overload shedding
                             #  for the ingest tiles (sock, gossip);
    [shed.stakes]            #  [shed.stakes] maps peer keys ("ip:port"
    "127.0.0.1:9001" = 500   #  or origin pubkey hex) to stake

    [tile.shed]              # per-tile override (same keys; highest
    rate_pps = 50.0          #  precedence), validated at topo.build

    [funk]                   # the account store (funk/shmfunk.py):
    backend = "shm"          #  "process" (dict tree) | "shm" (carved
    rec_max = 4096           #  into the workspace, shared by the bank,
    txn_max = 256            #  the resolv tile and the exec tile
    heap_mb = 16             #  family)

    [snapshot]               # cold start (tiles/snapshot.py): the file
    path = "snap.ckpt"       #  snapld streams and the replay writes,
    min_slot = 4             #  snapin's staleness gate, the replay's
    every_slots = 0          #  write cadence, zlib frames, snapld's
    compress = true          #  frag size
    chunk = 4096

Where the copy differs from the reference:
  * the tile-key gate (the reference's lint/registry.py, config.py:215)
    is the port's own table `TILE_ARGS`: the reference's keys for synth,
    verify, dedup, sink, pack, bank, poh, shred, sign, tower, repair,
    send, replay, sock, gossip, exec, resolv, metric, archiver, playback,
    snapld, snapdc and snapin, plus `device` on verify, bank, replay, gossip, exec and
    snapin (the card, "cuda", unless "cpu"); a gated key the port has
    not ported (pack's `bundle_in`, the bank's `rpc_port` and
    `ws_port`) passes the gate and is refused by its adapter;
  * the [replay] section is validated by `tiles/replay.normalize_replay`,
    the [funk] section by `funk/shmfunk.normalize_funk` and the
    [snapshot] section by `tiles/snapshot.normalize_snapshot`, and all
    three are carried on the plan;
  * each top-level section the reference accepts but the port has not
    ported (witness, flight, tune) raises NotImplementedError
    naming its ROADMAP.md queue-A item, and so does
    FDTPU_TUNED_PROFILE (item 11); a known kind without an adapter, a
    gated key the port lacks (the verify tile's `device_fail_limit`,
    which it refuses by design) and a chaos action of an unported kind
    pass the gate and are refused by `Topology.tile`
    (disco/unported.py).

As in the reference, `cpu0` on a sharded tile pins shard i to core
cpu0 + i, and on an unsharded tile it becomes that tile's `cpu_idx`
(config.py:323-335); [[slo.target]] arrays merge by name across layers.
"""
from __future__ import annotations

import difflib
import os
import tomllib

from ..disco.shed import normalize_shed
from ..disco.slo import normalize_slo
from ..disco.topo import Topology
from ..disco.unported import UNPORTED_KINDS, UNPORTED_SECTIONS, refuse
from ..funk.shmfunk import normalize_funk
from ..prof import normalize_prof
from ..tiles.snapshot import normalize_snapshot
from ..trace import normalize_trace

_TOP_SECTIONS = {"topology", "link", "tcache", "tile", "trace", "slo",
                 "prof", "replay", "shed", "funk", "snapshot",
                 *UNPORTED_SECTIONS}

# keys every tile understands (read by Topology.build, the launcher or
# the stem)
COMMON_KEYS = ("supervise", "chaos", "trace", "prof", "shed", "cpu_idx",
               "sandbox", "sandbox_files", "lazy_ns", "lazy_auto")
TILE_ARGS: dict[str, tuple[str, ...]] = {
    "synth": ("count", "burst", "unique", "seed", "rate_tps"),
    "verify": ("batch", "max_len", "tcache", "device_retries",
               "device_timeout_s", "device_fail_limit", "rr_cnt",
               "rr_idx", "devices", "coalesce_us", "tile_cnt", "cpu0",
               "mode", "prefilter_shed", "device"),
    "dedup": ("tcache", "batch"),
    "sink": ("batch",),
    "pack": ("txn_in", "bank_links", "done_links", "slot_in", "bundle_in",
             "slot_ms", "batch", "max_txn_per_microblock", "wave",
             "resolved_in"),
    "bank": ("exec", "poh_link", "forward_payloads", "slots_per_epoch",
             "genesis_ckpt", "genesis", "genesis_synth", "rpc_port",
             "ws_port", "wave", "redispatch_s", "exec_links", "exec_done",
             "device"),
    "poh": ("hashes_per_tick", "ticks_per_slot", "seed", "slot_link"),
    "shred": ("mode", "req", "resp", "cluster", "identity_hex",
              "shreds_link", "batches_link", "flush_bytes", "fanout",
              "shred_version", "drop_slot_every", "leader_pubkey_hex",
              "turbine_in"),
    "sign": ("seed", "clients"),
    "tower": ("total_stake",),
    "repair": ("req", "resp", "identity_hex", "port", "bind_addr", "peers",
               "root_slot"),
    "send": ("req", "resp", "identity_hex", "vote_account_hex", "dest"),
    "replay": ("genesis", "genesis_synth", "hashes_per_tick", "verify_poh",
               "slots_per_epoch", "exec_links", "exec_done",
               "redispatch_s", "expected", "wait_restore", "snapshot_path",
               "snapshot_every", "snapshot_compress", "device"),
    "sock": ("port", "bind_addr", "batch", "mtu"),
    "gossip": ("seed", "port", "bind_addr", "entrypoints", "publish",
               "device_verify", "gossvf_bulk", "device"),
    "exec": ("batch", "rr_cnt", "rr_idx", "tile_cnt", "cpu0", "device"),
    "resolv": ("batch", "fee_payer_check"),
    "metric": ("port", "bind_addr", "healthz_stale_s"),
    "archiver": ("path",),
    "playback": ("path",),
    "snapld": ("path", "chunk", "stale_path"),
    "snapdc": (),
    "snapin": ("format", "min_slot", "device"),
}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _merge_named_lists(base: list, over: list, where: str) -> list:
    """[[link]]/[[tile]] arrays merge by `name`: same-name entries
    deep-merge (override layer wins per key), new names append."""
    out = {}
    for src, entries in (("base", base), (where, over)):
        for e in entries:
            name = e.get("name")
            if not isinstance(name, str):
                raise ValueError(
                    f"{src}: array-of-tables entry missing 'name': {e}")
            out[name] = _deep_merge(out.get(name, {}), e)
    return list(out.values())


def load_config(*paths, overrides: dict | None = None) -> dict:
    """Parse + deep-merge TOML layers left-to-right (later wins), then
    apply the `overrides` dict (same by-name merge for link/tcache/tile
    arrays as TOML layers)."""
    cfg: dict = {}
    layers = [(p, None) for p in paths]
    if overrides:
        layers.append(("<overrides>", overrides))
    for p, preparsed in layers:
        if preparsed is None:
            with open(p, "rb") as f:
                layer = tomllib.load(f)
        else:
            layer = preparsed
        bad = set(layer) - _TOP_SECTIONS
        if bad:
            raise ValueError(f"{p}: unknown config sections {sorted(bad)}")
        for key in ("link", "tcache", "tile"):
            if key in layer:
                cfg[key] = _merge_named_lists(cfg.get(key, []),
                                              layer[key], str(p))
        for key in _TOP_SECTIONS - {"link", "tcache", "tile"}:
            if key in layer:
                merged = _deep_merge(cfg.get(key, {}), layer[key])
                if key == "slo" and "target" in layer[key]:
                    # [[slo.target]] arrays merge by name, as [[tile]]:
                    # a layer can tighten one objective alone
                    merged["target"] = _merge_named_lists(
                        cfg.get(key, {}).get("target", []),
                        layer[key]["target"], str(p))
                cfg[key] = merged
    return cfg


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(key, sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def _validate_tile_keys(t: dict):
    """Reject unknown [[tile]] keys with a did-you-mean hint; a kind of
    the reference the port lacks is left to Topology.tile's refusal."""
    kind = t["kind"]
    if kind in UNPORTED_KINDS:
        return
    if kind not in TILE_ARGS:
        raise ValueError(
            f"[[tile]] {t.get('name')!r}: unknown kind {kind!r}"
            + _suggest(str(kind), [*TILE_ARGS, *UNPORTED_KINDS]))
    known = {"name", "kind", "ins", "outs", *COMMON_KEYS, *TILE_ARGS[kind]}
    bad = set(t) - known
    if bad:
        key = sorted(bad)[0]
        raise ValueError(
            f"[[tile]] {t.get('name')!r} (kind {kind!r}): unknown "
            f"key(s) {sorted(bad)}" + _suggest(key, known))


def build_topology(cfg: dict, name: str | None = None) -> Topology:
    """Merged config -> Topology (unbuilt; caller runs .build())."""
    for key, item in UNPORTED_SECTIONS.items():
        if key in cfg:
            refuse(f"the [{key}] section", item)
    if os.environ.get("FDTPU_TUNED_PROFILE"):
        refuse("FDTPU_TUNED_PROFILE (tuned knob profiles)", 11)
    # fail before launch (trace/recorder.py, tiles/replay.py,
    # tiles/snapshot.py, funk/shmfunk.py, disco/shed.py, disco/slo.py
    # and prof/recorder.py are the validators; per-tile `shed` and
    # `prof` overrides validate, and SLO targets resolve, at
    # Topology.build)
    shed_cfg = cfg.get("shed")
    if shed_cfg is not None:
        normalize_shed(shed_cfg)
    trace_cfg = cfg.get("trace")
    if trace_cfg is not None:
        normalize_trace(trace_cfg)
    replay_cfg = cfg.get("replay")
    if replay_cfg is not None:
        # tiles.replay imports torch: only a config with [replay] pays
        from ..tiles.replay import normalize_replay
        normalize_replay(replay_cfg)
    funk_cfg = cfg.get("funk")
    if funk_cfg is not None:
        normalize_funk(funk_cfg)
    snap_cfg = cfg.get("snapshot")
    if snap_cfg is not None:
        normalize_snapshot(snap_cfg)
    slo_cfg = cfg.get("slo")
    if slo_cfg is not None:
        normalize_slo(slo_cfg)
    prof_cfg = cfg.get("prof")
    if prof_cfg is not None:
        normalize_prof(prof_cfg)
    top = cfg.get("topology", {})
    topo = Topology(name or top.get("name", f"cfg{os.getpid()}"),
                    wksp_size=int(top.get("wksp_size", 1 << 26)),
                    trace=trace_cfg, replay=replay_cfg, shed=shed_cfg,
                    funk=funk_cfg, slo=slo_cfg, prof=prof_cfg,
                    snapshot=snap_cfg)
    for ln in cfg.get("link", []):
        topo.link(ln["name"], depth=int(ln.get("depth", 128)),
                  mtu=int(ln.get("mtu", 1280)))
    for tc in cfg.get("tcache", []):
        topo.tcache(tc["name"], depth=int(tc.get("depth", 4096)))
    default_sup = top.get("supervise")
    for t in cfg.get("tile", []):
        if "kind" not in t:
            raise ValueError(f"[[tile]] {t.get('name')!r}: missing 'kind'")
        _validate_tile_keys(t)
        args = {k: v for k, v in t.items()
                if k not in ("name", "kind", "ins", "outs")}
        if default_sup:
            # topology-wide supervision defaults; the tile's own table
            # wins per key
            args["supervise"] = _deep_merge(default_sup,
                                            args.get("supervise", {}))
        tile_cnt = int(args.pop("tile_cnt", 1) or 1)
        cpu0 = args.pop("cpu0", None)
        if tile_cnt > 1:
            topo.sharded_tile(t["name"], t["kind"], tile_cnt,
                              ins=t.get("ins", ()),
                              outs=t.get("outs", ()), cpu0=cpu0, **args)
        else:
            if cpu0 is not None:
                # cpu0 on an unsharded tile pins it (shard 0)
                args["cpu_idx"] = int(cpu0)
            topo.tile(t["name"], t["kind"], ins=t.get("ins", ()),
                      outs=t.get("outs", ()), **args)
    return topo
