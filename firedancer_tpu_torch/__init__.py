"""PyTorch/CUDA port of firedancer_tpu for NVIDIA Hopper (H100).

The JAX package `firedancer_tpu` stays the reference. This package
imports neither it nor jax: every module it needs from there is copied
here, and every Pallas kernel on its path is a hand-written CUDA kernel
under `csrc/` with a plain PyTorch version beside its wrapper.

Slice 1 (this tree): strict ed25519 sigverify on the main path,
synth -> verify tile -> out ring, through two kernels (SHA-512 and the
fused verify).
"""
