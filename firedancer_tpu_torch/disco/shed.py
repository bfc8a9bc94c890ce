"""Load shedding + per-peer policing: the overload front door (copy of
the JAX package's disco/shed.py).

An internet-facing validator's ingest tiles (sock/quic/gossip) meet
the open internet BEFORE any expensive work runs — the reference's
stance is that flood traffic dies at the cheapest possible layer
(gossvf sigchecks ahead of CRDS, QUIC policing ahead of the TPU
reasm, ref: src/discof/gossip/ gossvf + src/waltz/quic/ conn quotas).
This module is that layer's policy engine, shared by every ingest
tile:

  * per-peer TOKEN BUCKETS: each source (socket address, or gossip
    origin pubkey) earns `rate_pps` admissions per second up to a
    `burst` bucket — one peer can never monopolize the door.
  * a BOUNDED peer table: at most `max_peers` tracked peers; a flood
    of fake identities evicts unstaked entries first (insertion
    order), and when every slot is staked a new unstaked peer is shed
    instead of evicting anyone — table memory is O(max_peers) no
    matter what the attacker does.
  * stake-weighted OVERLOAD shedding: when the tile detects pressure
    (out-ring backpressure, an explicit drop, or the metric tile's
    slo_breach gauge), the gate trips into overload for
    `overload_hold_s` (refreshed while pressure persists) and peers
    below `min_stake` are shed at the door — unstaked/low-stake
    traffic degrades first, staked traffic keeps its token budget.
    When pressure clears the hold expires and admission returns to
    rate-limiting only (deterministic recovery, no hysteresis state
    beyond the clock).

Config rides the topology as a `[shed]` section with per-tile
`[tile.shed]` overrides (the trace shape), validated at config load
(app/config.py) and at topo.build:

    [shed]
    enable = true
    rate_pps = 1000.0        # per-peer sustained admit rate
    burst = 64               # bucket depth (packets)
    max_peers = 4096         # bounded table; unstaked evicted first
    min_stake = 1            # stake floor while overloaded
    overload_hold_s = 1.0    # how long one pressure event sheds

    [shed.stakes]            # peer key -> stake; keys are "ip:port"
    "127.0.0.1:9001" = 500   # for socket peers, origin pubkey hex for
                             # gossip CRDS origins (disjoint namespaces
                             # share one table)

Shed outcomes surface as tile metric slots (shed / shed_unstaked /
shed_overflow / peers / overload), the counters the flood drills
(chip_smoke.py phase 19) read.

Where the copy differs from the reference:
  * the did-you-mean hint is a few lines of difflib, not the
    reference's lint/registry.suggest (fdlint is not ported);
  * PressureProbe, the overload roll-up the ingest doors poll, lives in
    disco/slo.py as in the reference and is imported here for the
    callers that reach it through this module.
"""
from __future__ import annotations

import difflib

from ..utils.tempo import monotonic_ns
from .slo import PressureProbe  # noqa: F401

SHED_DEFAULTS = {
    "enable": True,
    "rate_pps": 1000.0,
    "burst": 64.0,
    "max_peers": 4096,
    "min_stake": 1,
    "overload_hold_s": 1.0,
    "stakes": {},
}
# per-tile [tile.shed] override keys (partial table; topology section
# fills the rest)
TILE_SHED_KEYS = tuple(SHED_DEFAULTS)


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(str(key), sorted(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def normalize_shed(spec, per_tile: bool = False) -> dict:
    """Validate + default-fill a shed config table ([shed] section, or
    a tile's `shed` override with per_tile=True). Returns a plain
    JSON-able dict; raises ValueError with a did-you-mean on typos —
    the same fail-before-launch stance as supervise/trace/slo."""
    allowed = set(TILE_SHED_KEYS) if per_tile else set(SHED_DEFAULTS)
    out = {} if per_tile else dict(SHED_DEFAULTS)
    if spec is None:
        return out
    if not isinstance(spec, dict):
        raise ValueError(f"shed spec must be a table, got {spec!r}")
    unknown = set(spec) - allowed
    if unknown:
        key = sorted(unknown)[0]
        raise ValueError(f"unknown shed key(s) {sorted(unknown)}"
                         + _suggest(key, allowed))
    out.update(spec)
    if "enable" in out and out["enable"] is not None:
        out["enable"] = bool(out["enable"])
    if "rate_pps" in out:
        out["rate_pps"] = float(out["rate_pps"])
        if out["rate_pps"] <= 0:
            raise ValueError(
                f"shed.rate_pps must be > 0, got {out['rate_pps']}")
    if "burst" in out:
        out["burst"] = float(out["burst"])
        if out["burst"] < 1:
            raise ValueError(
                f"shed.burst must be >= 1, got {out['burst']}")
    if "max_peers" in out:
        out["max_peers"] = int(out["max_peers"])
        if out["max_peers"] < 2:
            raise ValueError(
                f"shed.max_peers must be >= 2, got {out['max_peers']}")
    if "min_stake" in out:
        out["min_stake"] = int(out["min_stake"])
        if out["min_stake"] < 0:
            raise ValueError(
                f"shed.min_stake must be >= 0, got {out['min_stake']}")
    if "overload_hold_s" in out:
        out["overload_hold_s"] = float(out["overload_hold_s"])
        if out["overload_hold_s"] <= 0:
            raise ValueError(
                f"shed.overload_hold_s must be > 0, got "
                f"{out['overload_hold_s']}")
    stakes = out.get("stakes")
    if stakes is not None:
        if not isinstance(stakes, dict):
            raise ValueError("shed.stakes must be a table of "
                             "peer-key -> stake")
        norm = {}
        for k, v in stakes.items():
            if not isinstance(k, str) or not k:
                raise ValueError(
                    f"shed.stakes key must be a non-empty string "
                    f"(\"ip:port\" or origin hex), got {k!r}")
            iv = int(v)
            if iv < 0:
                raise ValueError(
                    f"shed.stakes[{k!r}] must be >= 0, got {v!r}")
            norm[k] = iv
        out["stakes"] = norm
    return out


def effective_shed(topo_cfg: dict | None,
                   tile_override: dict | None) -> dict | None:
    """Resolve one tile's shed settings from the normalized topology
    section + the tile's own (normalized, per_tile) override. Returns
    the merged table when shedding is enabled for the tile, None when
    it is not (no gate object, zero per-packet cost)."""
    topo = normalize_shed(topo_cfg) if topo_cfg is not None else None
    over = normalize_shed(tile_override, per_tile=True) \
        if tile_override is not None else {}
    if topo is None and not over:
        return None
    base = dict(topo) if topo is not None else dict(SHED_DEFAULTS)
    stakes = dict(base.get("stakes", {}))
    stakes.update(over.get("stakes", {}))
    base.update(over)
    base["stakes"] = stakes
    if not base.get("enable", True):
        return None
    return base


def slo_breach_count(plan: dict, wksp) -> int:
    """Read the topology's metric tile's slo_breach gauge (0 when no
    metric tile / no SLO engine) — the cross-tile overload signal: an
    [slo] breach anywhere trips ingest tiles into shed mode, read-side
    only at housekeeping cadence."""
    from . import topo as topo_mod
    for tn, spec in plan.get("tiles", {}).items():
        if spec.get("kind") != "metric":
            continue
        names = spec.get("metrics_names", [])
        if "slo_breach" not in names:
            continue
        try:
            vals = topo_mod.read_metrics(wksp, plan, tn)
            return int(vals[names.index("slo_breach")])
        except Exception:        # noqa: BLE001 — teardown race
            return 0
    return 0


class PeerGate:
    """The per-tile policing gate: token buckets + bounded peer table
    + stake-weighted overload shedding. One instance per ingest tile
    (tables are per-tile by design, like ha-dedup tcaches); `admit` is
    the only hot-path call and does one dict lookup + float math."""

    __slots__ = ("rate", "burst", "max_peers", "min_stake", "hold_ns",
                 "stakes", "peers", "overload_until", "shed_total",
                 "shed_rate", "shed_unstaked", "shed_drop", "evicted",
                 "staked_rx", "staked_shed", "base_rate", "tighten")

    def __init__(self, cfg: dict):
        cfg = normalize_shed(cfg)
        self.rate = cfg["rate_pps"]
        self.base_rate = self.rate     # config value; `rate` is the
        self.tighten = 0               # tighten-scaled effective rate
        self.burst = cfg["burst"]
        self.max_peers = cfg["max_peers"]
        self.min_stake = cfg["min_stake"]
        self.hold_ns = int(cfg["overload_hold_s"] * 1e9)
        self.stakes: dict[str, int] = dict(cfg["stakes"])
        # key -> [tokens, last_refill_ns]; python dicts preserve
        # insertion order, which IS the eviction scan order
        self.peers: dict[str, list] = {}
        self.overload_until = 0
        # shed_total counts every rejected packet exactly once;
        # rate/unstaked/drop are attribution overlays (why it was shed)
        self.shed_total = 0
        self.shed_rate = 0
        self.shed_unstaked = 0
        self.shed_drop = 0            # drop-newest at a full door
        self.evicted = 0
        # the packets of peers with a stake the gate saw, and those of
        # them it shed: the door's own staked accounting (a harness
        # holds what it sent against it); not among `counters()`
        self.staked_rx = 0
        self.staked_shed = 0

    # -- identity ------------------------------------------------------------

    @staticmethod
    def key_of(addr) -> str:
        """A socket peer's table key: \"ip:port\" (matches the
        [shed.stakes] key format). Bytes (gossip origins) key by hex."""
        if isinstance(addr, tuple):
            return f"{addr[0]}:{addr[1]}"
        if isinstance(addr, (bytes, bytearray)):
            return bytes(addr).hex()
        return str(addr)

    def stake_of(self, key: str) -> int:
        return self.stakes.get(key, 0)

    def is_staked(self, addr) -> bool:
        """Does this peer clear the overload stake floor? (Used by
        doors that give staked traffic a bounded waiting room when the
        full-ring drain would otherwise drop it stake-blind.)"""
        return self.stakes.get(self.key_of(addr), 0) >= self.min_stake

    # -- overload mode -------------------------------------------------------

    def trip_overload(self, now: int | None = None):
        """Pressure observed (backpressure / drop / SLO breach): shed
        below-min_stake peers for the next overload_hold_s. Refreshing
        while pressure persists keeps the mode latched; expiry IS the
        recovery — no separate clear path to get wrong."""
        self.overload_until = (now if now is not None
                               else monotonic_ns()) + self.hold_ns

    def overloaded(self, now: int | None = None) -> bool:
        return (now if now is not None
                else monotonic_ns()) < self.overload_until

    def set_tighten(self, level: int):
        """fdtune shed_tighten knob: scale every peer's admit rate to
        base_rate/(1+level) — level 0 restores the config rate. Burst
        and the peer table are untouched, so loosening is instant and
        the knob composes with (does not replace) overload mode."""
        level = max(0, int(level))
        if level == self.tighten:
            return
        self.tighten = level
        self.rate = self.base_rate / (1 + level)

    # -- admission -----------------------------------------------------------

    def admit(self, addr, now: int | None = None) -> bool:
        """One packet from `addr`: True = admit, False = shed (the
        caller counts which). Order: overload stake gate first (the
        cheapest reject under attack — no table entry is ever created
        for a shed unstaked peer, so overload cannot grow the table),
        then the peer's token bucket."""
        if now is None:
            now = monotonic_ns()
        key = self.key_of(addr)
        stake = self.stakes.get(key, 0)
        ok = self._admit(key, stake, now)
        if stake:
            self.staked_rx += 1
            self.staked_shed += not ok
        return ok

    def _admit(self, key: str, stake: int, now: int) -> bool:
        if now < self.overload_until and stake < self.min_stake:
            self.shed_total += 1
            self.shed_unstaked += 1
            return False
        ent = self.peers.get(key)
        if ent is None:
            if len(self.peers) >= self.max_peers \
                    and not self._evict(stake):
                # every slot is staked and the newcomer isn't: shed it
                # rather than evict a staked peer
                self.shed_total += 1
                self.shed_unstaked += 1
                return False
            ent = self.peers[key] = [self.burst, now]
        tokens = min(self.burst,
                     ent[0] + (now - ent[1]) * self.rate / 1e9)
        ent[1] = now
        if tokens < 1.0:
            ent[0] = tokens
            self.shed_total += 1
            self.shed_rate += 1
            return False
        ent[0] = tokens - 1.0
        return True

    def _evict(self, newcomer_stake: int) -> bool:
        """Make room for a new peer: drop the oldest-inserted unstaked
        entries (a Sybil flood churns through here, never past
        max_peers); if every entry is staked, evict the oldest only
        for a staked newcomer. Amortized: one insertion-order scan per
        eviction burst, bounded batch so a full-table flood costs
        O(batch) per new peer, not O(max_peers) per packet."""
        victims = []
        budget = max(1, self.max_peers // 8)
        for k in self.peers:
            if self.stakes.get(k, 0) < self.min_stake or \
                    self.stakes.get(k, 0) == 0:
                victims.append(k)
                if len(victims) >= budget:
                    break
        if not victims:
            if newcomer_stake <= 0:
                return False
            victims = [next(iter(self.peers))]
        for k in victims:
            del self.peers[k]
        self.evicted += len(victims)
        return True

    def count_drop(self, addr):
        """Account one packet dropped-newest at a full door (overload
        drain — no admission ran, so `admit`'s counters don't know):
        one shed tick, attributed unstaked below the same min_stake
        floor `admit`'s overload gate uses — the counter must mean the
        same thing on both shed paths."""
        self.shed_total += 1
        self.shed_drop += 1
        stake = self.stakes.get(self.key_of(addr), 0)
        if stake < self.min_stake:
            self.shed_unstaked += 1
        if stake:
            self.staked_rx += 1
            self.staked_shed += 1

    # -- metrics -------------------------------------------------------------

    def counters(self) -> dict:
        return {"shed": self.shed_total,
                "shed_unstaked": self.shed_unstaked,
                "peers": len(self.peers),
                "overload": 1 if self.overloaded() else 0}
