"""The port's configure preflight (firedancer_tpu_torch/app/configure.py)
against the JAX package's on this host, and the port's `dev` command: the
stages come out in the same order with the same status (and the same
detail, but for the shm stage's free space, which moves between reads),
an impossible shm target fails both, `fix_nofile` raises the soft limit
toward the hard one, and the CLIs print the same stage lines and result
(tests/test_configure.py's four tests as cases); `dev --device cpu`
boots the leader with the genesis in bank0 and exits 0, and `dev` on
"cuda" without a card raises before it writes or boots anything."""
import json
import os
import resource
import subprocess
import sys

import pytest
import torch

from firedancer_tpu.app import configure as jcf
from firedancer_tpu_torch.app import configure as tcf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["shm", "hugepages", "nofile", "memlock", "cpus", "somaxconn",
         "overcommit"]


@pytest.mark.parametrize("wksp_bytes", [1 << 20, 1 << 50])
def test_check_is_the_references_on_this_host(wksp_bytes):
    ours, theirs = tcf.check(wksp_bytes), jcf.check(wksp_bytes)
    assert [s["stage"] for s in ours] == [s["stage"] for s in theirs] \
        == NAMES
    assert [s["status"] for s in ours] == [s["status"] for s in theirs]
    for a, b in zip(ours[1:], theirs[1:]):
        assert a == b, a["stage"]
    for s in ours:
        assert s["status"] in (tcf.PASS, tcf.WARN, tcf.FAIL)
        assert s["detail"]
    if wksp_bytes == 1 << 20:
        # 1 MiB of shm must exist on any runnable host
        assert ours[0]["status"] == tcf.PASS
    else:
        # a petabyte cannot: both fail or warn, with a fix
        assert ours[0]["status"] in (tcf.WARN, tcf.FAIL) and ours[0]["fix"]
        assert theirs[0]["fix"]


def test_fix_nofile_raises_soft_toward_hard():
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        want = min(hard, soft + 1) if hard != resource.RLIM_INFINITY \
            else soft + 1
        assert tcf.fix_nofile(want)
        assert resource.getrlimit(resource.RLIMIT_NOFILE)[0] >= want
        # already covered: nothing to raise, as the reference says
        assert tcf.fix_nofile(want) == jcf.fix_nofile(want) is True
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def test_fix_memlock_matches_the_reference():
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    try:
        assert tcf.fix_memlock() == jcf.fix_memlock()
        assert [s["status"] for s in tcf.fix(1 << 20)] \
            == [s["status"] for s in jcf.fix(1 << 20)]
    finally:
        resource.setrlimit(resource.RLIMIT_MEMLOCK, (soft, hard))


@pytest.mark.parametrize("argv", [["check", "--wksp-bytes", str(1 << 20)],
                                  ["fix", "--wksp-bytes", str(1 << 20)],
                                  ["bogus"]])
def test_cli_prints_as_the_reference(argv, capsys):
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        rcs, outs = [], []
        for mod in (tcf, jcf):
            rcs.append(mod.main(list(argv)))
            outs.append(capsys.readouterr().out.splitlines())
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    assert rcs[0] == rcs[1]
    if argv[0] == "bogus":
        assert rcs[0] == 1 and outs == [[], []]
        return
    assert rcs[0] in (0, 2)
    # the stage columns and the result line agree (the shm line's free
    # space may move between the two reads)
    cols = [[ln[:17] for ln in o[:-1]] for o in outs]
    assert cols[0] == cols[1] and len(cols[0]) == len(NAMES)
    assert "shm" in cols[0][0]
    assert json.loads(outs[0][-1]) == json.loads(outs[1][-1])
    assert set(json.loads(outs[0][-1])) == {"result"}


def test_dev_boots_the_leader_with_the_genesis_on_the_cpu():
    """`python -m firedancer_tpu_torch.app.dev --device cpu
    --skip-configure --duration 3`: the genesis, then cfg/leader.toml
    with it in bank0, every tile in the monitor table, exit 0."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.dev",
         "--device", "cpu", "--skip-configure", "--duration", "3",
         "--name", f"tdev{os.getpid()}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    out = p.stdout
    assert "== genesis ==" in out and "== boot ==" in out
    assert "genesis: 22 accounts, 2 validators" in out
    for tn in ("synth", "verify0", "verify1", "dedup", "pack", "bank0",
               "poh", "shred", "sign", "shredsink"):
        assert f"\n{tn} " in out, tn


def test_dev_leader_layers_put_the_genesis_in_bank0(tmp_path):
    """dev's layers: cfg/leader.toml, then an overlay that sets only
    bank0's genesis_ckpt (an absolute path)."""
    from firedancer_tpu_torch.app import config as tconfig
    from firedancer_tpu_torch.app.dev import LEADER_TOML, leader_layers
    layers = leader_layers("g.ckpt", str(tmp_path))
    assert layers[0] == LEADER_TOML and len(layers) == 2
    base = tconfig.load_config(LEADER_TOML)
    cfg = tconfig.load_config(*layers)
    tconfig.build_topology(cfg)
    tiles = {t["name"]: t for t in cfg["tile"]}
    assert tiles["bank0"]["genesis_ckpt"] == os.path.abspath("g.ckpt")
    tiles["bank0"].pop("genesis_ckpt")
    assert cfg == base


def test_dev_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No card: `dev` (device "cuda" by default) raises before the
    configure, the genesis or the boot."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: dev would boot on it")
    import tempfile

    from firedancer_tpu_torch.app import dev
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        dev.main(["--duration", "1"])
    assert os.listdir(tmp_path) == []
