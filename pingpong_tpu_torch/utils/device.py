"""Device selection for the port's entry points, and host reads of card
tensors that wait for their own copy only."""

from __future__ import annotations

from typing import List

import torch

from pingpong_tpu_torch.utils import trace


def resolve_device(device="cuda") -> torch.device:
    """The requested device. Entry points default to ``cuda``; with no
    card present that raises: the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "device='cpu') to run the plain PyTorch versions on the CPU")
    return dev


class Readout:
    """Card tensors copied to pinned host memory behind one event, queued
    on the current stream: :meth:`wait` waits for those copies only (a
    ``trace.readback``) and returns the host copies, whatever the stream
    queued after them. Host tensors are copied at once, with nothing to
    wait for."""

    def __init__(self, *values: torch.Tensor):
        self.event = None
        if not values[0].is_cuda:
            self.host = [v.clone() for v in values]
            return
        self.host = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                     for v in values]
        for h, v in zip(self.host, values):
            h.copy_(v, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(values[0].device))

    def wait(self) -> List[torch.Tensor]:
        if self.event is not None:
            trace.readback(self.event, torch.cuda.Event.synchronize)
        return self.host
