"""What the port refuses: the reference's topology sections, per-tile
args and tile kinds that have no counterpart here yet, each with the
ROADMAP.md queue-A item that ports it.

`app.config.build_topology` refuses the sections, `Topology.tile` the
kinds, the args (and `device_fail_limit`, which no item ports: the
port's verify tile does not degrade to the CPU) and the chaos actions;
the adapters refuse their own args (pack's `bundle_in`, item 13; the
bank's exec="general", item 15, `genesis_ckpt`, item 5 (5f), and
`rpc_port` and `ws_port`, item 16; the replay tile's snapshot args,
item 5 (5f); the sign tile's keyswitch region, item 13). The host
executor refuses every program but the system program and
ComputeBudget, and v0 transactions with address lookup tables
(svm/programs.py, item 15; the resolv tile resolves such tables with
svm/alut.py's read half). Nothing refused is silently ignored.
"""
from __future__ import annotations

# topology sections of the reference (the JAX package's
# disco/topo.py:85-126 and app/config.py's top-level tables); [witness]
# is the device probe of witness/ (item 6's other half, 6b)
UNPORTED_SECTIONS = {"snapshot": "5f", "flight": 10, "tune": 11,
                     "witness": "6b"}

# per-tile args of the reference that the port has not ported: the
# shred tile's fault seam for the repair tile's tests
# (tiles/shred.py:87)
UNPORTED_TILE_ARGS = {"drop_slot_every": 13}

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
# ported: the QUIC door's flood (item 3b: the door needs AES-GCM from
# the `cryptography` package), and the snapshot drills of snapld and of
# the replay's snapshot writer (the reference ignores an action no tile
# takes; the port refuses it)
UNPORTED_CHAOS_ACTIONS = {
    "flood_malformed_quic": "3b",
    **dict.fromkeys(("crash_mid_snapshot", "corrupt_checkpt_frame",
                     "stale_snapshot_offer"), "5f"),
}

# every kind of the reference's tile registry without an adapter here
UNPORTED_KINDS = {
    "quic": "3b",
    **dict.fromkeys(("snapld", "snapdc", "snapin"), "5f"),
    "gui": 9, "flight": 10, "controller": 11,
    "cswtch": 12, "netlnk": 12,
    **dict.fromkeys(("tower", "repair", "send", "archiver",
                     "playback", "bundle", "plugin", "vinyl", "ipecho",
                     "pcap"), 13),
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
