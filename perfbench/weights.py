"""Model weights made from the seed, on the device, in a few large draws.

The names and shapes are the reference model's (reference/tonet.py); the
program's model takes the same dict with a strict load, so a mismatch of
its module tree shows at once. Kernels (every parameter named "weight" with
two or more dimensions) are normals truncated at two standard deviations,
scaled by 1 / sqrt(fan_in) (flax's lecun_normal); norm scales and running
variances are 1, biases, offsets and running means 0.
"""

from __future__ import annotations

import math

import torch


def make_weights(model: torch.nn.Module, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every parameter and buffer
    of `model` (a module built on the meta device)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) >= 2]
    total = sum(math.prod(shapes[k]) for k in kernels)
    g = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            fan_in = math.prod(s[1:])
            out[k] = draw[at: at + n].view(s).mul(0.87962566103423978 ** -1 / math.sqrt(fan_in))
            at += n
        elif k.rsplit(".", 1)[-1] in ("scale", "var"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out
