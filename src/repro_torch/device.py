"""The port's device rule: entry points run on the card unless the caller asks
for the CPU by name."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device that is not there raises instead of
    letting the caller run on the CPU unawares."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run on the CPU "
            "on purpose")
    return device
