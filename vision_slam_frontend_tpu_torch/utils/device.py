"""The device an entry point runs on: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """The requested device; a CUDA request without a CUDA device fails."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (the port runs on "
            "the GPU; pass --device cpu / device='cpu' to run its plain "
            "PyTorch versions on the CPU)"
        )
    return device
