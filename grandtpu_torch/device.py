"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fallback from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for "cuda"/"cpu" (or a device); raises if CUDA is
    asked for and absent."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return device
