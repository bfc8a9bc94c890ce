"""Resolution of the `device` argument every public entry point takes.

The port runs on the card unless the caller asks for the CPU. There is
no silent fallback: `"cuda"` without a usable card raises."""
from __future__ import annotations


def resolve(device="cuda") -> "torch.device":
    """-> torch.device; raises RuntimeError for CUDA without a card.
    torch is imported here, not with the module: every tile process
    imports this module, and a tile that runs no kernel boots without
    torch."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
