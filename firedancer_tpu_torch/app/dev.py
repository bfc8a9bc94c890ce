"""`dev` command: one-command local development cluster (copy of the JAX
package's app/dev.py).

    python -m firedancer_tpu_torch.app.dev [--device cuda|cpu]
        [--duration 30] [--validators 2] [--skip-configure]

The fddev-dev analog (ref: src/app/shared_dev/commands/dev.c:40-100 —
"auto-configure, genesis creation, keygen, single-machine cluster",
README.md:47-56): runs the configure preflight, builds a genesis
checkpoint (funded users + initialized vote/stake accounts per
validator), then boots the port's leader topology
(firedancer_tpu_torch/cfg/leader.toml) with the genesis layered into
bank0 by an overlay — ending at the same live monitor `run` gives, with
zero hand-written config.

Where the copy differs from the reference: it boots cfg/leader.toml (the
port's default leader loop; the reference boots cfg/default.toml) and
takes `--device`, which `app.run` sets on every device tile. `"cuda"`
(the default) without a card raises before anything is written or
booted. The genesis directory is removed when the run ends.
`leader_layers` builds the config layers, so that a harness
(tools/cluster.py) boots the very leader `dev` boots.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

LEADER_TOML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfg", "leader.toml")


def leader_layers(ckpt: str, out_dir: str) -> list[str]:
    """The leader's config layers for the genesis checkpoint `ckpt`:
    cfg/leader.toml, then an overlay written into `out_dir` that sets
    bank0's `genesis_ckpt` (config layers merge per key). -> paths."""
    overlay = os.path.join(out_dir, "dev-overlay.toml")
    with open(overlay, "w") as f:
        f.write(f'[[tile]]\nname = "bank0"\n'
                f'genesis_ckpt = {json.dumps(os.path.abspath(ckpt))}\n')
    return [LEADER_TOML, overlay]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="firedancer_tpu_torch dev")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of every verify, bank, replay, gossip, "
                         "exec and snapin tile (app.run's --device)")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--validators", type=int, default=2)
    ap.add_argument("--user-accounts", type=int, default=16)
    ap.add_argument("--name", default=None)
    ap.add_argument("--skip-configure", action="store_true")
    args = ap.parse_args(argv)

    from ..device import resolve
    resolve(args.device)     # no card for "cuda": raise, boot nothing

    from . import configure as cfg_mod
    if not args.skip_configure:
        print("== configure check ==")
        worst = cfg_mod.PASS
        for st in cfg_mod.fix():
            line = (f"[{st['status']:4s}] {st['stage']:<10s} "
                    f"{st['detail']}")
            print(line)
            if st["status"] == cfg_mod.FAIL:
                worst = cfg_mod.FAIL
        if worst == cfg_mod.FAIL:
            print("(continuing — dev mode tolerates FAIL stages)")

    print("== genesis ==")
    from .genesis import main as genesis_main
    tmp = tempfile.mkdtemp(prefix="fdtt-dev-")
    try:
        ckpt = os.path.join(tmp, "genesis.ckpt")
        rc = genesis_main([ckpt, "--validators", str(args.validators),
                           "--user-accounts", str(args.user_accounts)])
        if rc:
            print("genesis failed", file=sys.stderr)
            return rc

        print("== boot ==")
        from .run import main as run_main
        run_args = [*leader_layers(ckpt, tmp), "--device", args.device,
                    "--duration", str(args.duration)]
        if args.name:
            run_args += ["--name", args.name]
        return run_main(run_args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
