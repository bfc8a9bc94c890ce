"""Drains of the leader topology (firedancer_tpu_torch/cfg/leader.toml)
booted by a TopologyRunner, and the check of the shreds it mirrored;
used by chip_smoke.py phase 12 and tests/test_torch_leader.py.

`wait_drained` is bench.py's `_leader_wait_drained` (bench.py:554-583):
every synth frame has a terminal outcome, executed by bank0 or dropped at
a named hop, and pack has retired every microblock. The loop itself never
goes quiet (poh ticks on), so `drain_shred_leg` then halts every tile
upstream of the shred tile, whose stems flush what they staged, waits
until the shred tile has taken every entry poh published and shredsink
every wire the shred tile mirrored, and halts the rest. `check_mirror`
reads the shreds still in the mirror ring and holds each to its FEC set's
merkle root (its proof) and the root to the set's signature.
"""
from __future__ import annotations

import time

SHRED_LEG = ("shred", "sign", "shredsink")


def verify_shards(runner) -> list[str]:
    return [tn for tn in runner.plan["tiles"] if tn.startswith("verify")]


def dropped(runner) -> int:
    """Frames dropped at a named hop: dedup's duplicates, pack's parse
    failures and each verify shard's parse, dedup and verify failures."""
    n = runner.metrics("dedup")["dup"] + runner.metrics("pack")["parse_fail"]
    for tn in verify_shards(runner):
        v = runner.metrics(tn)
        n += v["parse_fail"] + v["dedup_drop"] + v["verify_fail"]
    return n


def wait_drained(runner, count: int, timeout_s: float,
                 poll_s: float = 0.002) -> int:
    """Block until bank0's txns plus the dropped frames reach `count`
    and pack's completions equal its microblocks. -> dropped."""
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        p, b = runner.metrics("pack"), runner.metrics("bank0")
        d = dropped(runner)
        if b["txns"] + d >= count and p["completions"] == p["microblocks"]:
            return d
        if time.monotonic() > deadline:
            raise TimeoutError(f"leader loop never drained: pack {p}, "
                               f"bank {b}, dropped {d}")
        time.sleep(poll_s)


def drain_shred_leg(runner, timeout_s: float, poll_s: float = 0.01) -> dict:
    """Halt every tile but the shred leg; wait until shred.entries equals
    poh.entries and shredsink.rx equals the shreds the shred tile made
    (data + parity); halt the shred leg. -> {tile: metrics}."""
    runner.halt(tiles=[tn for tn in runner.procs if tn not in SHRED_LEG])
    poh_entries = runner.metrics("poh")["entries"]
    deadline = time.monotonic() + timeout_s
    while True:
        runner.check_failures()
        s, snk = runner.metrics("shred"), runner.metrics("shredsink")
        made = s["data_shreds"] + s["parity_shreds"]
        if s["entries"] == poh_entries and snk["rx"] == made:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"shred leg never drained: poh entries "
                               f"{poh_entries}, shred {s}, shredsink {snk}")
        time.sleep(poll_s)
    runner.halt()
    return {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}


def mirror_wires(runner, link: str = "shreds_mirror") -> list[bytes]:
    """Every wire still in the mirror ring, oldest first (the ring holds
    its last `depth` frames)."""
    from ..runtime import Ring
    li = runner.plan["links"][link]
    ring = Ring(runner.wksp, li["ring_off"], li["depth"], li["arena_off"],
                li["mtu"])
    seq = max(0, int(ring.seq) - li["depth"])
    out = []
    while True:
        rc, frag = ring.consume(seq)
        if rc != 0:
            return out
        out.append(bytes(ring.payload(frag)))
        seq += 1


def check_mirror(wires, pubkey: bytes) -> int:
    """Each shred's proof leads from its merkle leaf to one root for its
    FEC set, and the set's signature verifies under `pubkey` over that
    root (the check of tests/test_shred.py:150, from the wires alone).
    Raises AssertionError. -> the number of FEC sets seen."""
    from ..shred import format as fmt
    from ..shred.merkle import root_from_proof, shred_merkle_leaf
    from ..utils.ed25519_ref import verify
    roots: dict = {}
    for w in wires:
        s = fmt.parse_shred(w)
        if fmt.is_data(s.variant):
            leaf_idx = s.idx - s.fec_set_idx
            region = fmt.data_merkle_region_sz(s.variant)
        else:
            leaf_idx = s.data_cnt + s.code_idx
            region = fmt.code_merkle_region_sz(s.variant)
        root = root_from_proof(shred_merkle_leaf(w[64:64 + region]),
                               leaf_idx, list(s.proof))
        key = (s.slot, s.fec_set_idx)
        if key not in roots:
            assert verify(s.signature, pubkey, root), \
                f"set {key}: signature does not cover its root"
            roots[key] = (root, s.signature)
        assert roots[key] == (root, s.signature), \
            f"set {key}: shred {s.idx} proves another root"
    return len(roots)
