"""The port's device rule: entry points run on the card unless the caller asks
for the CPU by name."""

from __future__ import annotations

import subprocess

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


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them: the stamp every
    measurement on the card is kept with (a card set below its maximum
    power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]
