"""The port stands alone: firedancer_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, nor does a tile process the port's
launcher spawns, and entry points refuse to run on a card that is not
there."""
import ast
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "firedancer_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "firedancer_tpu")


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, sys, firedancer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'firedancer_tpu_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'firedancer_tpu'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 35 and not bad, bad\n"
        "new = {'ops.cuda_sha256', 'ops.cuda_blake3', 'ops.blake3', "
        "'ops.bmtree', 'ops.reedsol', 'utils.blake3_ref', 'utils.gf256', "
        "'utils.chacha', 'shred.shredder', 'shred.shred_dest', "
        "'tiles.shred', 'keyguard.tile', 'tools.leader_drain', "
        "'svm.accdb', 'svm.sysvars', 'svm.programs', "
        "'flamenco.bank_hash', 'shred.store', 'shred.fec_resolver', "
        "'tiles.tower', 'tiles.replay', 'trace', 'trace.events', "
        "'trace.recorder', 'trace.export', 'trace.cli', "
        "'trace.__main__', 'utils.chaos', 'disco.shed', 'tiles.sock', "
        "'tiles.gossip', 'gossip', 'gossip.gossvf', 'gossip.bloom', "
        "'gossip.crds', 'gossip.active_set', 'gossip.protocol', "
        "'flamenco.gossip_wire', 'tools.paced_sender', "
        "'tools.gossvf_bench', 'funk.shmfunk', 'svm.alut', "
        "'tools.exec_drills', 'disco.slo', 'disco.httpd', 'prof', "
        "'prof.recorder', 'prof.device', 'prof.export', 'prof.cli', "
        "'prof.__main__', 'utils.checkpt', 'tiles.snapshot', "
        "'flamenco.snapshot', 'tiles.archiver', 'app.backtest', "
        "'tools.catchup', 'vm', 'vm.interp', 'vm.asm', 'vm.syscalls', "
        "'vm.elf', 'vm.trace', 'svm.loader', 'svm.accdb_cold', "
        "'svm.txncache', 'groove', 'groove.groove', 'utils.ristretto', "
        "'utils.bn254', 'tools.sbpf_elf', 'tools.sbpf_family', "
        "'waltz', 'waltz.quic', 'waltz.tls', 'utils.x25519', "
        "'tiles.quic', 'tools.quic_load', 'tune', 'tune.controller', "
        "'tune.search', 'tune.profile', 'tune.cli', 'tune.__main__', "
        "'flight', 'flight.codec', 'flight.archive', 'flight.recorder', "
        "'flight.cli', 'flight.__main__', 'tools.e2e'}\n"
        "assert {'firedancer_tpu_torch.' + m for m in new} <= set(mods)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("entry", ["ed25519", "cuda_ed"])
def test_verify_batch_without_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = __import__(f"firedancer_tpu_torch.ops.{entry}", fromlist=["x"])
    z = np.zeros((2, 64), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.verify_batch(z, z[:, :32], z, np.zeros(2, np.int32))


@pytest.mark.parametrize("entry", ["ed25519", "cuda_msm"])
def test_rlc_verify_batch_without_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = __import__(f"firedancer_tpu_torch.ops.{entry}", fromlist=["x"])
    z = np.zeros((2, 64), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.rlc_verify_batch(z, z[:, :32], z, np.zeros(2, np.int32),
                             z[:, :16])


def _tile_probe(plan, tile_name, q, extra):
    """Run a tile process's entry point, then report the forbidden
    modules it holds (and the error of `extra`, code run after it)."""
    from firedancer_tpu_torch.disco.launch import tile_main
    tile_main(plan, tile_name)
    bad = sorted(k for k in sys.modules if _forbidden(k))
    try:
        exec(extra or "")
    except AssertionError as e:
        bad.append(f"extra: {e!r}")
    q.put(bad)


def _spawn_and_probe(topo, tn, extra=None):
    """Spawn tile `tn` of `topo` through the launcher's entry point, wait
    for RUN, halt it, and hold it to loading no forbidden module (and to
    the assertions of `extra`, run in the tile process after it)."""
    from firedancer_tpu_torch.runtime import (CNC_HALT, CNC_RUN, Cnc,
                                              Workspace)
    plan = topo.build()
    w = Workspace(plan["wksp"]["name"], plan["wksp"]["size"], create=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_tile_probe, args=(plan, tn, q, extra),
                    daemon=True)
    p.start()
    try:
        cnc = Cnc(w, off=plan["tiles"][tn]["cnc_off"])
        deadline = time.time() + 120
        while cnc.state != CNC_RUN:
            assert p.is_alive() and time.time() < deadline, \
                f"the {tn} tile never reached RUN"
            time.sleep(0.02)
        cnc.state = CNC_HALT
        assert q.get(timeout=60) == []
        p.join(30)
        assert not p.is_alive() and p.exitcode == 0
    finally:
        if p.is_alive():
            p.kill()
            p.join(10)
        w.close()
        w.unlink()


def test_spawned_verify_tile_process_loads_no_jax():
    from firedancer_tpu_torch.disco import Topology
    _spawn_and_probe(
        Topology(f"ttimp{os.getpid()}", wksp_size=1 << 22)
        .link("in", depth=16, external=True)
        .link("out", depth=16, external=True)
        .tcache("tc", depth=64)
        .tile("verify", "verify", ins=["in"], outs=["out"], batch=16,
              device="cpu"), "verify")


def test_spawned_traced_verify_tile_with_a_fault_plan_loads_no_jax():
    """The flight recorder's writer, the stem's chaos harness and the
    verify tile's fault path in a tile process."""
    from firedancer_tpu_torch.disco import Topology
    _spawn_and_probe(
        Topology(f"ttimpt{os.getpid()}", wksp_size=1 << 22,
                 trace={"enable": True, "depth": 64})
        .link("in", depth=16, external=True)
        .link("out", depth=16, external=True)
        .tcache("tc", depth=64)
        .tile("verify", "verify", ins=["in"], outs=["out"], batch=16,
              device="cpu", device_timeout_s=5.0, chaos={"events": [
                  {"action": "fail_dispatch", "count": 1},
                  {"action": "freeze_hb", "at_iter": 1 << 40}]}),
        "verify")


def test_spawned_bank_tile_process_loads_no_jax():
    """The bank tile with exec="svm" (the wave executor, its kernel's
    wrapper, funk, the conflict DAG, pack's cost model) on the CPU."""
    from firedancer_tpu_torch.disco import Topology
    _spawn_and_probe(
        Topology(f"ttimpb{os.getpid()}", wksp_size=1 << 22)
        .link("mb", depth=16, mtu=4096, external=True)
        .link("done", depth=16, mtu=64, external=True)
        .link("poh", depth=16, mtu=4160, external=True)
        .tile("bank0", "bank", ins=["mb"], outs=["done", "poh"],
              exec="svm", poh_link="poh", forward_payloads=True,
              genesis_synth=16, device="cpu"), "bank0")


def test_spawned_front_door_tile_processes_load_no_jax():
    """The sock door with a [shed] policy, and the gossip tile with
    gossvf on the plain versions (device_verify, gossvf_bulk, "cpu")."""
    from firedancer_tpu_torch.disco import Topology
    topo = (Topology(f"ttimpf{os.getpid()}", wksp_size=1 << 22,
                     shed={"rate_pps": 50.0, "max_peers": 8})
            .link("out", depth=16, external=True)
            .tile("sock", "sock", outs=["out"], batch=8))
    _spawn_and_probe(topo, "sock")
    _spawn_and_probe(
        Topology(f"ttimpg{os.getpid()}", wksp_size=1 << 22)
        .tile("gossip", "gossip", seed=bytes(32).hex(), device="cpu",
              device_verify=True, gossvf_bulk=True), "gossip")


def test_spawned_exec_family_tile_processes_load_no_jax():
    """An exec tile (its boot wave on the plain wave scan), a resolv tile
    with the fee-payer gate, and a replay tile with the exec fan-out,
    each joined to a [funk] shm store carved by the build."""
    from firedancer_tpu_torch.disco import Topology

    def topo(tag):
        return Topology(f"ttimpx{tag}{os.getpid()}", wksp_size=1 << 24,
                        funk={"backend": "shm", "heap_mb": 1,
                              "rec_max": 256, "txn_max": 16})
    _spawn_and_probe(
        topo("e").link("disp", depth=16, mtu=4096, external=True)
        .link("done", depth=16, mtu=64, external=True)
        .tile("exec0", "exec", ins=["disp"], outs=["done"], batch=8,
              device="cpu"), "exec0")
    _spawn_and_probe(
        topo("r").link("in", depth=16, external=True)
        .link("out", depth=16, mtu=2048, external=True)
        .tile("resolv", "resolv", ins=["in"], outs=["out"]), "resolv")
    _spawn_and_probe(
        topo("p").link("slices", depth=16, mtu=1 << 16, external=True)
        .link("tower", depth=16, mtu=128, external=True)
        .link("disp", depth=16, mtu=4096, external=True)
        .link("done", depth=16, mtu=64, external=True)
        .tile("replay", "replay", ins=["slices", ("done", False)],
              outs=["tower", "disp"], exec_links=["disp"],
              exec_done=["done"], genesis_synth=4, device="cpu"),
        "replay")


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.funk.shmfunk", "firedancer_tpu_torch.svm.alut",
    "firedancer_tpu_torch.disco.tiles",
    "firedancer_tpu_torch.tools.exec_drills"])
def test_exec_family_module_loads_no_jax(mod):
    """Each module of the exec tile family, the shm store and resolv,
    imported alone in a fresh interpreter."""
    test_leader_leg_module_loads_no_jax(mod)


def test_spawned_metric_tile_process_loads_no_jax_and_no_cuda():
    """The metric tile (its HTTP server, the SLO engine with a target,
    the prometheus renderer) and a profiled verify tile on the CPU whose
    breach capture is warmed at boot: neither holds jax, and the metric
    tile never initialises CUDA."""
    from firedancer_tpu_torch.disco import Topology
    _spawn_and_probe(
        Topology(f"ttimpm{os.getpid()}", wksp_size=1 << 22,
                 slo={"target": [{"name": "t",
                                  "expr": "verify.work p99 < 1ms"}]},
                 prof={"enable": True, "hz": 97,
                       "breach_capture": ["verify"]})
        .link("in", depth=16, external=True)
        .link("out", depth=16, external=True)
        .tcache("tc", depth=64)
        .tile("verify", "verify", ins=["in"], outs=["out"], batch=16,
              device="cpu")
        .tile("metric", "metric", port=0), "metric",
        extra="import torch; assert not torch.cuda.is_initialized()")


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.disco.slo", "firedancer_tpu_torch.disco.httpd",
    "firedancer_tpu_torch.disco.metrics",
    "firedancer_tpu_torch.disco.monitor", "firedancer_tpu_torch.prof",
    "firedancer_tpu_torch.prof.device", "firedancer_tpu_torch.prof.export",
    "firedancer_tpu_torch.prof.cli"])
def test_observatory_module_loads_no_jax(mod):
    """Each module of the metric tile, the SLO engine and fdprof,
    imported alone in a fresh interpreter."""
    test_leader_leg_module_loads_no_jax(mod)


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.disco.shed", "firedancer_tpu_torch.tiles.sock",
    "firedancer_tpu_torch.tiles.gossip", "firedancer_tpu_torch.gossip.gossvf",
    "firedancer_tpu_torch.flamenco.gossip_wire",
    "firedancer_tpu_torch.tools.paced_sender"])
def test_front_door_module_loads_no_jax(mod):
    """Each module of the front door, imported alone in a fresh
    interpreter."""
    test_leader_leg_module_loads_no_jax(mod)


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.trace", "firedancer_tpu_torch.trace.cli",
    "firedancer_tpu_torch.utils.chaos", "firedancer_tpu_torch.disco.stem",
    "firedancer_tpu_torch.disco.supervise"])
def test_trace_and_chaos_module_loads_no_jax(mod):
    """Each module of the flight recorder and the chaos harness, imported
    alone in a fresh interpreter."""
    test_leader_leg_module_loads_no_jax(mod)


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.tune", "firedancer_tpu_torch.tune.controller",
    "firedancer_tpu_torch.tune.search", "firedancer_tpu_torch.tune.profile",
    "firedancer_tpu_torch.tune.cli", "firedancer_tpu_torch.flight",
    "firedancer_tpu_torch.flight.codec",
    "firedancer_tpu_torch.flight.archive",
    "firedancer_tpu_torch.flight.recorder",
    "firedancer_tpu_torch.flight.cli", "firedancer_tpu_torch.tools.e2e"])
def test_tune_and_flight_module_loads_no_jax(mod):
    """Each module of fdtune, fdflight and the sweep's measurement,
    imported alone in a fresh interpreter."""
    test_leader_leg_module_loads_no_jax(mod)


def test_controller_and_flight_tiles_boot_without_torch(tmp_path):
    """The controller and flight tiles run no kernel: their tile entry
    point (disco/launch.tile_main), run in a fresh interpreter on a plan
    built here with a synth -> sink pipeline, reaches RUN and halts with
    neither torch nor jax loaded."""
    import json
    from firedancer_tpu_torch.disco import Topology
    from firedancer_tpu_torch.runtime import Workspace
    arch = tmp_path / "arch"
    plan = (Topology(f"ttimpc{os.getpid()}", wksp_size=1 << 22, tune={},
                     trace={"enable": True, "depth": 64},
                     flight={"dir": str(arch), "hz": 50.0})
            .link("a_b", depth=16, mtu=256)
            .tile("s", "synth", outs=["a_b"], count=8, unique=4)
            .tile("k", "sink", ins=["a_b"])
            .tile("ctl", "controller").tile("flight", "flight").build())
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    code = (
        "import json, sys, threading, time\n"
        "from firedancer_tpu_torch.disco.launch import tile_main\n"
        "from firedancer_tpu_torch.runtime import (CNC_HALT, CNC_RUN, "
        "Cnc, Workspace)\n"
        f"plan = json.load(open({str(path)!r}))\n"
        "w = Workspace(plan['wksp']['name'], plan['wksp']['size'], "
        "create=False)\n"
        "ths = [threading.Thread(target=tile_main, args=(plan, tn)) "
        "for tn in ('ctl', 'flight')]\n"
        "for t in ths: t.start()\n"
        "cncs = [Cnc(w, off=plan['tiles'][tn]['cnc_off']) "
        "for tn in ('ctl', 'flight')]\n"
        "deadline = time.time() + 60\n"
        "while any(c.state != CNC_RUN for c in cncs):\n"
        "    assert time.time() < deadline, 'never reached RUN'\n"
        "    time.sleep(0.02)\n"
        "time.sleep(0.2)\n"
        "for c in cncs: c.state = CNC_HALT\n"
        "for t in ths: t.join(30)\n"
        "assert not any(t.is_alive() for t in ths)\n"
        "w.close()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'firedancer_tpu'))\n"
        "assert not bad, bad[:8]\n")
    try:
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=ROOT),
                           capture_output=True, text=True, timeout=120)
    finally:
        Workspace.unlink_name(plan["wksp"]["name"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert any(n.startswith("seg-") for n in os.listdir(arch))


@pytest.mark.parametrize("mod", [
    "firedancer_tpu_torch.svm.executor", "firedancer_tpu_torch.svm.accdb",
    "firedancer_tpu_torch.ops.cuda_wave", "firedancer_tpu_torch.ops.poh",
    "firedancer_tpu_torch.funk.funk", "firedancer_tpu_torch.replay.rdisp",
    "firedancer_tpu_torch.pack.scheduler", "firedancer_tpu_torch.pack.cost",
    "firedancer_tpu_torch.utils.base58"])
def test_leader_leg_module_loads_no_jax(mod):
    """Each module of the leader's execution leg, imported alone in a
    fresh interpreter."""
    code = (f"import sys, {mod}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'firedancer_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
