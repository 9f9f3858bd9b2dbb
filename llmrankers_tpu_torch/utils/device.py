"""The device the port runs on: the card unless the caller names another."""
from __future__ import annotations

import torch


def resolve_device(device=None, cpu_hint: str = "pass device='cpu'") -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None. A CUDA device
    raises when no GPU is present instead of falling back to the CPU;
    ``cpu_hint`` says how the caller asks for the CPU."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available; {cpu_hint} to run on the CPU")
    return device
