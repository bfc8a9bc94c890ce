"""The port's gossvf (firedancer_tpu_torch/gossip/gossvf.py) on
device="cpu", where every kernel runs its plain version, against the
reference's gossip/gossvf.py: the packets of tests/test_gossip_tile.py
(six values, every third with a zero signature, and a malformed one)
and of tests/test_flood.py (four valid NodeInstance values, then a mix
with a corrupt signature), and packets with torsion-malleated values.

The reference runs its strict path eagerly in JAX and its bulk equation
through `_RLC_FN`, replaced here by the Python-int RLC oracle of
tests/test_flood.py (a jitted MSM trace on the CPU costs minutes), as
test_flood.py does; the port runs its real plain RLC. Both draw z from
generators of one seed, so they decide the same batch equation.

Also: a value longer than MAX_SIGNABLE (the reference's width rule), the
unknown-mode error, a failing bulk warmup raising out of the gossip
tile's constructor, an error of gossvf leaving GossipTile.poll_once
instead of counting as bad_msg, and the gossip adapter refusing
device_verify without a card. Verdicts are booleans: exact."""
import dataclasses
import hashlib
import os
import socket
import time

import numpy as np
import pytest
import torch

from firedancer_tpu.gossip import gossvf as rgv
from firedancer_tpu.gossip.crds import CrdsValue as RefValue
from firedancer_tpu_torch.flamenco import gossip_wire as gw
from firedancer_tpu_torch.gossip import gossvf as tgv
from firedancer_tpu_torch.gossip.crds import KIND_NODE_INSTANCE, CrdsValue
from firedancer_tpu_torch.tools.gossvf_bench import make_packet
from firedancer_tpu_torch.utils import ed25519_ref as ref
from test_flood import host_rlc


class _Z:
    """A generator stand-in whose every draw is z = 8 (z = 0 mod 8: the
    cofactored equation cannot see a torsion residual)."""

    def integers(self, lo, hi, shape, dtype):
        z = np.zeros(shape, dtype)
        z[:, 0] = 8
        return z


def _tile_packet():
    """tests/test_gossip_tile.py:83's packet, and the same with its first
    value unsigned (the malformed class)."""
    vals = []
    for i in range(6):
        seed = bytes([i + 1]) * 32
        pub = ref.keypair(seed)[2]
        v = CrdsValue(pub, 1, 0, 1000 + i, b"data-%d" % i)
        sig = bytes(64) if i % 3 == 2 else ref.sign(seed, v.signable())
        vals.append(dataclasses.replace(v, signature=sig))
    return vals, [dataclasses.replace(vals[0], signature=b"")] + vals[1:]


def _flood_packets():
    """tests/test_flood.py:577's packets: four valid values, then
    [valid, corrupt signature, valid]."""
    vals = []
    for i in range(4):
        seed = hashlib.sha256(b"gv-%d" % i).digest()
        pub = ref.keypair(seed)[2]
        data = pub + i.to_bytes(8, "little") + bytes(8)
        v = CrdsValue(pub, KIND_NODE_INSTANCE, 0, i, data)
        vals.append(dataclasses.replace(v, signature=ref.sign(
            seed, v.signable())))
    bad = dataclasses.replace(vals[1], signature=b"\x01" * 64)
    return vals, [vals[0], bad, vals[2]]


def _as_ref(vals):
    return [RefValue(v.origin, v.kind, v.index, v.wallclock, v.data,
                     v.signature) for v in vals]


# name -> (values, mode, z source); "seed" draws z from
# default_rng(11) on both sides
CASES = {
    "tile_individual": (lambda: _tile_packet()[0], "individual", "seed"),
    "tile_malformed_bulk": (lambda: _tile_packet()[1], "bulk", "seed"),
    "flood_valid_bulk": (lambda: _flood_packets()[0], "bulk", "seed"),
    "flood_mixed_bulk": (lambda: _flood_packets()[1], "bulk", "seed"),
    "torsion_mix_bulk": (lambda: make_packet(
        ["valid", "torsion", "forged", "malformed", "valid"], seed=1),
        "bulk", "seed"),
    "torsion_rigged_z_bulk": (lambda: make_packet(
        ["valid", "torsion", "valid"], seed=2), "bulk", "rigged"),
}
WANT = {
    "tile_individual": [True, True, False, True, True, False],
    "tile_malformed_bulk": [False, True, False, True, True, False],
    "flood_valid_bulk": [True] * 4,
    "flood_mixed_bulk": [True, False, True],
    "torsion_mix_bulk": [True, False, False, False, True],
    # cofactored: with z = 0 mod 8 the batch holds and the torsion lane
    # passes its prechecks, in both packages alike
    "torsion_rigged_z_bulk": [True, True, True],
}


def _rng(src):
    return _Z() if src == "rigged" else np.random.default_rng(11)


@pytest.fixture(scope="module")
def reference_verdicts():
    """Each case through the reference once (its eager JAX strict path
    takes some 15 s a call on the CPU)."""
    saved = rgv._RLC_FN, rgv._Z_RNG

    def oracle(sig, pub, msg, ln, z):
        ok, pre = host_rlc(sig, pub, msg, ln, z)
        return np.bool_(ok), pre
    rgv._RLC_FN = oracle
    try:
        out = {}
        for name, (mk, mode, src) in CASES.items():
            rgv._Z_RNG = _rng(src)
            out[name] = rgv.batch_verify(_as_ref(mk()), mode=mode)
        return out
    finally:
        rgv._RLC_FN, rgv._Z_RNG = saved


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_verify_matches_reference(name, reference_verdicts):
    mk, mode, src = CASES[name]
    vals = mk()
    got = tgv.batch_verify(vals, mode, "cpu", _rng(src))
    assert got == reference_verdicts[name] == WANT[name]
    if src == "seed":
        # the strict path decides alike where the batch equation failed
        assert tgv.batch_verify(vals, "individual", "cpu") == got


def test_oversize_value_takes_the_host_oracle():
    """A signable past MAX_SIGNABLE (no datagram carries one): the
    reference's width rule, the host oracle's verdict, beside a normal
    value in the same packet."""
    seed = bytes([9]) * 32
    pub = ref.keypair(seed)[2]
    big = CrdsValue(pub, 9, 0, 5, bytes(tgv.MAX_SIGNABLE + 40))
    signed = dataclasses.replace(big, signature=ref.sign(seed,
                                                         big.signable()))
    forged = dataclasses.replace(signed, signature=ref.sign(seed, b"x"))
    small = make_packet(["valid"], seed=3)
    for mode in ("individual", "bulk"):
        vals = [signed, forged] + small
        got = tgv.batch_verify(vals, mode, "cpu", np.random.default_rng(1))
        assert got == [True, False, True]
        # alone, the oversize values never reach the kernels
        assert tgv.batch_verify([signed, forged], mode, "cpu") == \
            rgv.batch_verify(_as_ref([signed, forged]), mode=mode) == \
            [True, False]


def test_unknown_mode_and_empty_packet():
    with pytest.raises(ValueError, match="unknown gossvf mode"):
        tgv.batch_verify(make_packet(["valid"]), "warp", "cpu")
    assert tgv.batch_verify([], "bulk", "cpu") == []
    assert tgv.RLC_LANES == rgv.RLC_LANES == 32
    assert tgv.RLC_WIDTH == rgv.RLC_WIDTH == 1280


def test_failing_bulk_warmup_raises_from_the_tile(monkeypatch):
    """The reference's tile logs a failed warmup and drops to
    individual-only; the port's constructor raises it."""
    from firedancer_tpu_torch.ops import cuda_msm
    from firedancer_tpu_torch.tiles.gossip import GossipTile

    def boom(*a, **kw):
        raise RuntimeError("msm_stage1 kernel launch failed: cudaError 719")
    monkeypatch.setattr(cuda_msm, "rlc_verify_batch", boom)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        GossipTile(bytes(32), device_verify=True, gossvf_bulk=True,
                   device="cpu")


def test_bulk_warmup_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from firedancer_tpu_torch.tiles.gossip import GossipTile
    with pytest.raises(RuntimeError, match="CUDA"):
        GossipTile(bytes(32), device_verify=True, gossvf_bulk=True)


def _push_datagram():
    seed = bytes([4]) * 32
    pub = ref.keypair(seed)[2]
    v = make_packet(["valid"], seed=4)[0]
    return gw.encode_container(gw.MSG_PUSH, pub, [v.to_wire()])


@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_gossvf_error_leaves_poll_once(monkeypatch, exc):
    """An error of gossvf (a launch failure, or a ValueError of a
    wrapper) goes out of poll_once, where the stem marks the tile FAIL;
    it is not a hostile datagram, so bad_msg stays 0."""
    from firedancer_tpu_torch.tiles.gossip import GossipTile

    def boom(*a, **kw):
        raise exc("ed25519_verify kernel launch failed")
    tile = GossipTile(bytes(32), device_verify=True, device="cpu")
    monkeypatch.setattr(tgv, "batch_verify", boom)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        tx.sendto(_push_datagram(), tile.addr)
        time.sleep(0.05)
        with pytest.raises(exc, match="launch failed"):
            tile.poll_once()
        assert tile.metrics["bad_msg"] == 0
        # hostile bytes still count as bad_msg and never raise
        tile.inject(b"\x02\x00\x00\x00" + bytes(10), ("192.0.2.1", 9))
        assert tile.metrics["bad_msg"] == 1
    finally:
        tx.close()
        tile.close()


def test_gossip_adapter_refuses_device_verify_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from firedancer_tpu_torch.disco import Topology
    from firedancer_tpu_torch.disco.tiles import adapter_class
    from firedancer_tpu_torch.disco.topo import TileCtx
    from firedancer_tpu_torch.runtime import Workspace
    plan = (Topology(f"tgvad{os.getpid()}", wksp_size=1 << 20)
            .tile("g", "gossip", seed=bytes(32).hex(), device_verify=True)
            .build())
    ctx = TileCtx(plan, "g")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            adapter_class("gossip")(ctx, plan["tiles"]["g"]["args"])
        # device_verify off: the host oracle, no card needed
        a = adapter_class("gossip")(ctx, {"seed": bytes(32).hex()})
        a.on_halt()
    finally:
        ctx.close()
        Workspace.unlink_name(plan["wksp"]["name"])
