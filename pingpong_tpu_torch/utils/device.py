"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device. Entry points default to ``cuda``; with no
    card present that raises: the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "device='cpu') to run the plain PyTorch versions on the CPU")
    return dev
