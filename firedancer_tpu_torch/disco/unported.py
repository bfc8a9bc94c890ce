"""What the port refuses: the reference's topology sections, per-tile
args and tile kinds that have no counterpart here yet, each with the
ROADMAP.md queue-A item that ports it.

`app.config.build_topology` refuses the sections, `Topology.tile` the
kinds and the args; the adapters refuse their own args (the verify
tile's degradation args, item 2; pack's `resolved_in`, item 5, and
`bundle_in`, item 13; the bank's exec="general", item 15, exec tile
family and `genesis_ckpt`, item 5, and `rpc_port` and `ws_port`, item
16). Nothing refused is silently ignored.
"""
from __future__ import annotations

# topology sections of the reference (the JAX package's
# disco/topo.py:85-126 and app/config.py's top-level tables)
UNPORTED_SECTIONS = {"trace": 2, "prof": 6, "slo": 8, "shed": 3,
                     "funk": 5, "replay": 5, "snapshot": 5, "flight": 10,
                     "tune": 11, "witness": 6}

# per-tile args of the reference that the port has not ported: the
# trace/prof/shed overrides its build reads (topo.py:366-459), the
# stem's chaos harness (stem.py:96), core pinning (launch.py:52-57,
# topo.py:219) and the stem's lazy housekeeping cadence (stem.py:36-52)
UNPORTED_TILE_ARGS = {
    "trace": 2, "prof": 6, "shed": 3,
    "chaos": "2 (fault plans) and item 3 (traffic plans)",
    **dict.fromkeys(("cpu_idx", "cpu0", "lazy_ns", "lazy_auto"), 14),
}

# every kind of the reference's tile registry without an adapter here
UNPORTED_KINDS = {
    **dict.fromkeys(("sock", "quic", "gossip"), 3),
    # shred needs bmtree and reedsol (item 4) and the sign tile (13)
    "shred": 4,
    **dict.fromkeys(("exec", "resolv", "replay", "snapld", "snapdc",
                     "snapin"), 5),
    "metric": 8, "gui": 9, "flight": 10, "controller": 11,
    "cswtch": 12, "netlnk": 12,
    **dict.fromkeys(("sign", "tower", "repair", "send", "archiver",
                     "playback", "bundle", "plugin", "vinyl", "ipecho",
                     "pcap"), 13),
}


def refuse(what: str, item):
    """Raise for a part of the reference the port has not ported yet,
    naming the ROADMAP.md queue-A item that ports it."""
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue A item {item}")
