"""Process launcher + policy-driven supervisor (copy of the JAX package's
disco/launch.py).

One spawned process per tile (ref: src/disco/topo/fd_topo_run.c:65-190;
run.c:229-260,925: "one tile dies => everything dies" by default); the
plan dict is the only shared contract. The runner writes the plan JSON
next to the shm segment so a monitor can attach by topology name.
Supervision policy is per tile (disco/supervise.py).

Where the copy differs from the reference:
  * tiles are spawned (launch.py:110), never forked: the runner may
    already hold a CUDA context, which a forked child must not inherit;
    nothing in a tile process imports jax or the JAX package (the
    reference's `_setup_jax`, launch.py:40-51, is gone);
  * `start` loads the native runtime and, when a verify, bank, replay
    or gossip tile runs on the card, builds the CUDA kernels once in the
    runner before any tile spawns, so the tiles load finished libraries
    instead of racing to build them;
  * a tile whose adapter fails to construct (a kernel that does not
    build or launch in a tile's warmup, an unported kind)
    leaves its cnc in FAIL and exits non-zero, so the supervisor tears
    the topology down; a tile halted while it booted exits without
    running;
  * the plan file is `/dev/shm/fdtt_<name>.plan.json`, and no pid file
    is written (it serves the cswtch tile, ROADMAP.md queue A item 12).

Core pinning is the reference's (launch.py:52-57): a tile's `cpu_idx`
arg pins its process with `os.sched_setaffinity` to the cpu_idx-th core
of the process's affinity set (modulo its size), before anything else
runs in the tile process.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import time

from ..runtime import Workspace, Cnc, CNC_FAIL, CNC_RUN, CNC_HALT
from . import topo as topo_mod
from .stem import Stem
from .supervise import Supervisor, sup_counters
from .tiles import adapter_class
from .topo import TileCtx


def tile_main(plan: dict, tile_name: str):
    """Entry point of a tile process (ref: fd_topo_run_tile)."""
    args = plan["tiles"][tile_name]["args"]
    # core pinning (ref: src/util/tile/fd_tile.h:6-38): this tile process
    # to one core of the set it may run on
    cpu_idx = args.get("cpu_idx")
    if cpu_idx is not None:
        avail = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {avail[int(cpu_idx) % len(avail)]})
    # sandbox hardening (ref: src/util/sandbox/fd_sandbox.h, the
    # python-enforceable subset)
    if args.get("sandbox"):
        from ..utils import sandbox
        sandbox.apply(max_files=int(args.get("sandbox_files", 1024)),
                      close_high_fds=False)
    if args.get("device") == "cpu":
        # a tile on the plain versions computes in its own process: one
        # torch thread each, or eight tile processes' thread pools
        # oversubscribe the host's cores (cfg/leader.toml's verify warmup
        # took some 40 times longer)
        import torch
        torch.set_num_threads(1)
    from ..utils import log
    log.init(f"{plan['topology']}:{tile_name}")
    log.info("tile booting")
    ctx = TileCtx(plan, tile_name)
    try:
        try:
            adapter = adapter_class(plan["tiles"][tile_name]["kind"])(
                ctx, args)
            stem = Stem(ctx, adapter)
        except BaseException as e:
            ctx.cnc.state = CNC_FAIL
            log.err(f"tile boot failed: {e!r}")
            raise
        # a halt requested while the tile booted stands: the stem would
        # set RUN over it (stem.py:238 in the reference too), and the
        # tile would run on until the runner's join timeout killed it
        if ctx.cnc.state != CNC_HALT:
            stem.run()
    finally:
        ctx.close()


def plan_path(topology_name: str) -> str:
    return f"/dev/shm/fdtt_{topology_name}.plan.json"


def _on_card(t: dict) -> bool:
    """Does tile `t` of a plan run kernels on the card: a verify, replay or
    exec tile, a bank tile with exec="svm", a gossip tile with
    `device_verify` or a snapin tile with format="archive", whose
    `device` is not "cpu"."""
    if t["kind"] == "bank" and t["args"].get("exec", "stub") != "svm":
        return False
    if t["kind"] == "gossip" and not t["args"].get("device_verify"):
        return False
    if t["kind"] == "snapin" and t["args"].get("format") != "archive":
        return False
    return t["kind"] in ("verify", "bank", "replay", "gossip", "exec",
                         "snapin") \
        and str(t["args"].get("device", "cuda")).startswith("cuda")


def prebuild(plan: dict):
    """Build what the tile processes would otherwise build at once, in
    this process: the native runtime (loaded by importing runtime), and
    the CUDA kernels when a tile runs kernels on the card (`_on_card`)
    and a card is there (without one, the tile fails its boot as it must)."""
    if not any(_on_card(t) for t in plan["tiles"].values()):
        return
    import torch
    if torch.cuda.is_available():
        from ..ops import _build
        _build.build_all()


class TopologyRunner:
    """Build-products holder + launcher + supervisor."""

    def __init__(self, plan: dict):
        self.plan = plan
        self.wksp = Workspace(plan["wksp"]["name"], plan["wksp"]["size"],
                              create=False)
        self.procs: dict[str, mp.process.BaseProcess] = {}
        self._mp = mp.get_context("spawn")
        self._halted = False
        self.supervisor = Supervisor(
            plan, self.wksp, procs=lambda: self.procs,
            spawn=self._spawn, halt_all=self._halt_for_supervisor)
        with open(plan_path(plan["topology"]), "w") as f:
            json.dump(plan, f)

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, tn: str, rejoin: bool = False):
        plan = self.plan
        if rejoin:
            # a deep copy only the child sees: the respawned consumer
            # joins its in rings at the producers' CURRENT seq
            plan = json.loads(json.dumps(self.plan))
            plan["tiles"][tn]["rejoin_at_tail"] = True
            # a chaos drill simulates one fault per boot: the
            # replacement comes up clean unless the plan sets "rearm"
            # (a crash-loop drill that opens the breaker on purpose)
            ch = plan["tiles"][tn]["args"].get("chaos")
            if not (isinstance(ch, dict) and ch.get("rearm")):
                plan["tiles"][tn]["args"].pop("chaos", None)
        p = self._mp.Process(target=tile_main, args=(plan, tn),
                             name=f"tile:{tn}", daemon=True)
        p.start()
        self.procs[tn] = p
        return p

    def start(self, tiles=None):
        prebuild(self.plan)
        for tn in (tiles or self.plan["tiles"]):
            self._spawn(tn)
        return self

    def _cnc(self, tn: str) -> Cnc:
        return Cnc(self.wksp, off=self.plan["tiles"][tn]["cnc_off"])

    def wait_running(self, timeout_s: float):
        """Block until every launched tile reaches RUN (the verify tile's
        warmup builds and first launches its kernels before that)."""
        t0 = time.time()
        for tn in list(self.procs):
            while self._cnc(tn).state != CNC_RUN:
                self.check_failures()
                if time.time() - t0 > timeout_s:
                    raise TimeoutError(f"tile {tn} never reached RUN")
                time.sleep(0.01)
        return self

    def check_failures(self):
        """One supervision pass: fail-fast tiles raise on abnormal death;
        restart-policy tiles are respawned with backoff, wedged tiles
        are killed by the watchdog, and an exhausted restart budget
        raises CircuitOpen after a clean halt."""
        if not self._halted:
            self.supervisor.poll()

    def supervise(self, duration_s: float, poll_s: float = 0.02):
        """Run supervision passes for duration_s."""
        deadline = time.time() + duration_s
        while time.time() < deadline:
            self.check_failures()
            time.sleep(poll_s)
        return self

    def heartbeats(self) -> dict[str, int]:
        """Ticks since each tile's last heartbeat."""
        now = topo_mod.now_ticks()
        return {tn: max(0, now - self._cnc(tn).last_heartbeat)
                for tn in self.procs}

    def metrics(self, tile_name: str):
        vals = topo_mod.read_metrics(self.wksp, self.plan, tile_name)
        names = self.plan["tiles"][tile_name]["metrics_names"]
        out = {nm: int(vals[i]) for i, nm in enumerate(names)}
        # supervisor counters ride in the region's top slots
        out.update(sup_counters(vals))
        return out

    def _halt_for_supervisor(self):
        self.halt(join_timeout_s=10.0)

    def halt(self, join_timeout_s: float = 30.0, tiles=None):
        """Halt the tiles named in `tiles` (default: every tile, which
        also ends supervision) and join them. Halting the upstream tiles
        first lets the downstream ones drain what was published: a tile
        that exits after a halt is not a failure to the supervisor."""
        names = list(self.procs) if tiles is None else list(tiles)
        if tiles is None:
            self._halted = True
        for tn in names:
            self._cnc(tn).state = CNC_HALT
        deadline = time.time() + join_timeout_s
        for tn in names:
            p = self.procs[tn]
            p.join(max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        return self

    def close(self, unlink: bool = True):
        name = self.plan["wksp"]["name"]
        self.wksp.close()
        if unlink:
            try:
                os.unlink(plan_path(self.plan["topology"]))
            except OSError:
                pass
            Workspace.unlink_name(name)

    # -- convenience -------------------------------------------------------

    def wait_idle(self, tile_name: str, metric: str, target: int,
                  timeout_s: float, poll_s: float = 0.05):
        """Poll one tile's metric until it reaches target."""
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            self.check_failures()
            if self.metrics(tile_name).get(metric, 0) >= target:
                return self
            time.sleep(poll_s)
        raise TimeoutError(
            f"{tile_name}.{metric} never reached {target}: "
            f"{self.metrics(tile_name)}")
