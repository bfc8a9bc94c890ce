"""gossvf's packets on the card: verdicts against the plain versions, and
the time a packet takes in each mode.

    python firedancer_tpu_torch/tools/gossvf_bench.py [--iters 20]

A packet is a list of CRDS NodeInstance values from distinct origins, as
one gossip push carries (1 to 18 on the wire; 32 is the bulk filter's
pinned lane count, 33 one past it). Each value is of one class:

  valid      signed by its origin;
  forged     a valid signature with one bit of S flipped;
  torsion    torsion_sign's RLC-evasion forgery with the origin's own key
             (R* = rB + T, T pure 8-torsion): strict verify rejects it, the
             cofactored batch equation accepts it iff z = 0 mod 8;
  malformed  no signature at all (an empty one).

`check` runs each packet through gossip/gossvf.batch_verify in both
modes on the card and on the CPU (the plain versions) with generators
of one seed, and raises on a difference (`verdicts` and `compare` are
its halves, so the plain versions can run in worker processes);
`time_modes` gives each mode's
ms per packet, by CUDA events around 20 calls (host packing, the
copies, the kernels and the read of the verdicts). chip_smoke.py phase
19a runs both."""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

CLASSES = ("valid", "forged", "torsion", "malformed")


def make_packet(classes, seed: int = 0) -> list:
    """[CrdsValue] of NodeInstance values, one per entry of `classes`."""
    from firedancer_tpu_torch.flamenco import gossip_wire as gw
    from firedancer_tpu_torch.gossip.crds import KIND_NODE_INSTANCE, CrdsValue
    from firedancer_tpu_torch.utils import ed25519_ref as ref
    from firedancer_tpu_torch.utils.chaos import torsion_sign
    out = []
    for i, cls in enumerate(classes):
        if cls not in CLASSES:
            raise ValueError(f"unknown value class {cls!r}")
        kseed = hashlib.sha256(b"gossvf-%d-%d" % (seed, i)).digest()
        pub = ref.keypair(kseed)[2]
        data = gw.encode_node_instance(pub, 1000 + i, seed, i)
        v = CrdsValue(pub, KIND_NODE_INSTANCE, 0, 1000 + i, data)
        if cls == "malformed":
            out.append(v)
            continue
        if cls == "torsion":
            _, sig = torsion_sign(kseed, v.signable())
        else:
            sig = bytearray(ref.sign(kseed, v.signable()))
            if cls == "forged":
                sig[40] ^= 0x08
        out.append(CrdsValue(pub, KIND_NODE_INSTANCE, 0, 1000 + i, data,
                             bytes(sig)))
    return out


def mixed(n: int) -> list[str]:
    """Classes cycling valid, forged, torsion, malformed."""
    return [CLASSES[i % 4] for i in range(n)]


# phase 19a's packets: the wire's 1, 2, 7 and 18 values, the filter's 32
# and one past it; all-valid ones pass the bulk equation, mixed ones fall
# to the strict kernels
PACKETS = {"1_valid": ["valid"], "2_mixed": mixed(2),
           "7_valid": ["valid"] * 7, "18_mixed": mixed(18),
           "32_valid": ["valid"] * 32, "33_mixed": mixed(33)}


def one_thread():
    """A pool worker's initializer: one torch thread a process."""
    import torch
    torch.set_num_threads(1)


def verdicts(name: str, device="cuda", seed: int = 7) -> dict:
    """{mode: verdicts} of packet `name` of PACKETS through
    gossvf.batch_verify on `device`, a generator of `seed` a mode."""
    from firedancer_tpu_torch.gossip import gossvf
    vals = make_packet(PACKETS[name], seed=list(PACKETS).index(name))
    return {mode: gossvf.batch_verify(vals, mode, device,
                                      np.random.default_rng(seed))
            for mode in ("individual", "bulk")}


def compare(got: dict, plain: dict):
    """Raise unless each packet's verdicts on the card equal the plain
    versions' in both modes, and equal the classes (valid only)."""
    for name, classes in PACKETS.items():
        if got[name] != plain[name]:
            raise AssertionError(f"gossvf {name}: card {got[name]} != plain "
                                 f"{plain[name]}")
        want = [c == "valid" for c in classes]
        if got[name]["individual"] != want or got[name]["bulk"] != want:
            raise AssertionError(f"gossvf {name}: verdicts {got[name]} for "
                                 f"{classes}")


def check(device="cuda") -> dict:
    """Every packet of PACKETS on `device` and on the CPU; raises on a
    difference. -> {packet: {mode: verdicts}}."""
    got = {name: verdicts(name, device) for name in PACKETS}
    compare(got, {name: verdicts(name, "cpu") for name in PACKETS})
    return got


def time_modes(sizes=(1, 2, 7, 18, 32), iters: int = 20,
               device="cuda") -> dict:
    """{mode: {n: ms per packet}} on all-valid packets of n values."""
    import torch
    from firedancer_tpu_torch.gossip import gossvf
    rng = np.random.default_rng(3)
    out = {"individual": {}, "bulk": {}}
    for n in sizes:
        vals = make_packet(["valid"] * n, seed=100 + n)
        for mode in out:
            gossvf.batch_verify(vals, mode, device, rng)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                gossvf.batch_verify(vals, mode, device, rng)
            t1.record()
            t1.synchronize()
            out[mode][n] = t0.elapsed_time(t1) / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    for name, modes in check().items():
        print(name, modes)
    print(time_modes(iters=args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
