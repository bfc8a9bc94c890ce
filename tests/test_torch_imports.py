"""The port stands alone: firedancer_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, and entry points refuse to run on a
card that is not there."""
import ast
import os
import subprocess
import sys

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
        "assert len(mods) >= 15 and not bad, bad\n")
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
