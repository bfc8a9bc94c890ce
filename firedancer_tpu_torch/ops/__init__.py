"""Device ops: plain PyTorch versions and their CUDA kernels."""
