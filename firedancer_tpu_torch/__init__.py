"""PyTorch/CUDA port of firedancer_tpu for NVIDIA Hopper (H100).

The JAX package `firedancer_tpu` stays the reference. This package
imports neither it nor jax: every module it needs from there is copied
here, and every Pallas kernel on its path is a hand-written CUDA kernel
under `csrc/` with a plain PyTorch version beside its wrapper.

What it holds: strict ed25519 sigverify (SHA-512 and the fused verify
kernels) and the RLC batch equation (the two MSM kernels) under `ops/`;
the verify tile over shm rings (`tiles/verify.py`); and the topology
layer (`disco/`, `app/`), which boots synth -> verify -> dedup -> sink
as four tile processes from `cfg/sigverify.toml`:

    python -m firedancer_tpu_torch.app.run \\
        firedancer_tpu_torch/cfg/sigverify.toml [--device cpu]
"""
