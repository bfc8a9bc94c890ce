"""`run` command: boot a topology from TOML config layers (copy of the
JAX package's app/run.py).

    python -m firedancer_tpu_torch.app.run \\
        firedancer_tpu_torch/cfg/sigverify.toml [more.toml ...] \\
        [--device cuda|cpu] [--duration S] [--name N]

Loads the config stack, materializes the topology, spawns every tile,
runs the supervisor (fail-fast by default), prints the monitor table
periodically, and tears down on SIGINT or after --duration seconds.
`--device` (default cuda) sets `device` on every verify, bank, replay,
gossip, exec and snapin tile: on the card their kernels run; without one the first such
tile fails its boot, the supervisor tears the topology down and the
command exits 1. `cpu` runs the kernels' plain versions. A metric tile
takes no device: it reads shared memory only. The table also lists the
recent SLO breaches, when the topology has an [slo] section.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..disco.launch import TopologyRunner
from ..disco.monitor import (format_slo_events, format_table,
                             slo_breach_events, snapshot)
from .config import build_topology, load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="firedancer_tpu_torch run")
    ap.add_argument("config", nargs="+", help="TOML layers, later wins")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of every verify, bank, replay, "
                         "gossip, exec and snapin tile")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to run (0 = until SIGINT)")
    ap.add_argument("--name", default=None, help="topology name override")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="monitor refresh seconds")
    ap.add_argument("--boot-timeout", type=float, default=600.0,
                    help="seconds to wait for every tile to reach RUN "
                         "(the verify tile's warmup builds its kernels)")
    args = ap.parse_args(argv)

    topo = build_topology(load_config(*args.config), name=args.name)
    for t in topo.tiles.values():
        if t.kind in ("verify", "bank", "replay", "gossip", "exec",
                      "snapin"):
            t.args["device"] = args.device
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=args.boot_timeout)
        t0 = time.monotonic()   # duration clock starts once tiles RUN
        next_print = 0.0
        while not args.duration \
                or time.monotonic() - t0 < args.duration:
            # supervision at a fast cadence, the table at --interval
            runner.check_failures()
            now = time.monotonic()
            if now >= next_print:
                frame = format_table(snapshot(runner.plan, runner.wksp))
                slo = format_slo_events(
                    slo_breach_events(runner.plan, runner.wksp))
                print(frame + ("\n" + slo if slo else ""), flush=True)
                next_print = now + args.interval
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    except (RuntimeError, TimeoutError) as e:
        print(f"run: {e}", file=sys.stderr)
        return 1
    finally:
        runner.halt()
        runner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
