"""What the port refuses: the reference's topology sections, per-tile
args and tile kinds that have no counterpart here yet, each with the
ROADMAP.md queue-A item that ports it.

`app.config.build_topology` refuses the sections, `Topology.tile` the
kinds, `device_fail_limit` (which no item ports: the port's verify tile
does not degrade to the CPU) and the chaos actions;
the adapters refuse their own args (pack's `bundle_in`, item 13; the
bank's `rpc_port` and `ws_port`, item 16; the sign tile's keyswitch
region, item 13). Nothing refused is silently ignored.
"""
from __future__ import annotations

# topology sections of the reference (the JAX package's
# disco/topo.py:85-126 and app/config.py's top-level tables); [witness]
# is the device probe of witness/ (item 6's other half, 6b)
UNPORTED_SECTIONS = {"witness": "6b"}

# per-tile args of the reference that the port refuses by design (a
# deliberate difference, ROADMAP.md C, not a queue-A item): the verify
# tile's degradation to the host reference after consecutive device
# failures (tiles/verify.py:849-960). The port never verifies on the CPU
# on the card's behalf: a failure that outlasts the retries fails the
# tile, and the supervisor restarts it.
REFUSED_TILE_ARGS = {
    "device_fail_limit": "the verify tile does not degrade to the CPU",
}

# chaos actions (utils/chaos.ACTIONS) whose tile kind or seam is not
# ported, each with its item (the reference ignores an action no tile
# takes, the port refuses it); every action has its tile now
UNPORTED_CHAOS_ACTIONS: dict[str, object] = {}

# every kind of the reference's tile registry without an adapter here
UNPORTED_KINDS = {
    "gui": 9, "cswtch": 12, "netlnk": 12,
    **dict.fromkeys(("bundle", "plugin", "vinyl", "ipecho", "pcap"), 13),
}


def refuse_by_design(what: str, why: str):
    """Raise for a part of the reference the port leaves out on purpose."""
    raise NotImplementedError(
        f"{what} is refused by design ({why}): ROADMAP.md C")


def refuse(what: str, item):
    """Raise for a part of the reference the port has not ported yet,
    naming the ROADMAP.md queue-A item that ports it."""
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue A item {item}")
