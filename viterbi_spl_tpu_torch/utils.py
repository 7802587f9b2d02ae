"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises when CUDA is wanted (explicitly or by default) and
    absent, so that a run never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    return dev


def on_device(device: torch.device):
    """A context that makes `device` the current CUDA device (a kernel
    launches on the current device's stream); nothing for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
