"""Layers the port's models share, with flax.linen's numerics in PyTorch's
NCHW layout.

- `BatchNorm`: flax BatchNorm over the channel axis (dim 1): running
  averages, or (`batch_stats=True`) the input batch's own mean and biased
  variance, epsilon 1e-5; it never updates the running averages. The
  variance is E[(x - E[x])^2], two passes. flax 0.12's default is
  E[x^2] - E[x]^2, which cancels where the variance is small against the
  mean's square: the SF modules normalize chunk means across a track's
  chunks, and on such means (variance 1.8e-6 of the square) flax's float32
  output is 0.012 off float64, the two-pass one 3.5e-5
  (scripts/precision_probe.py). The result is float32 where the
  layer has a scale or a bias (flax promotes to the params' dtype), else
  the input's dtype.
- `LayerNorm`: flax LayerNorm over the last axis (the same variance rule).
- `Conv` / `Dense`: a convolution or a dense layer that runs in the compute
  dtype it is given (float32, or bfloat16 under mixed precision) with
  float32 params, as flax's `dtype=` does. `padding="same"` pads as XLA
  does for stride 1 (the odd pad on the high side), "valid" not at all;
  `dilation` as flax's `kernel_dilation`.

Params use PyTorch's layouts (OIHW kernels, [out, in] dense weights);
models/convert.py carries flax's across.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

F32 = torch.float32


def _as(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class BatchNorm(nn.Module):
    def __init__(self, n: int, use_scale: bool = True, use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(n)) if use_bias else None
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        xf = x.to(F32)
        if batch_stats:
            axes = [d for d in range(x.ndim) if d != 1]
            mu = xf.mean(dim=axes)
            var = ((xf - mu.view(shape)) ** 2).mean(dim=axes)
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (xf - mu.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        params = self.scale is not None or self.bias is not None
        return y if params else y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, n: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(F32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        return (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class Conv(nn.Module):
    """A 1-D or 2-D convolution (len(kernel) says which) in the compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding: str = "same",
                 bias: bool = True, dilation=1):
        super().__init__()
        kernel = tuple(kernel)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self._conv = F.conv1d if len(kernel) == 1 else F.conv2d

    def forward(self, x: torch.Tensor, dtype=F32) -> torch.Tensor:
        return self._conv(x.to(dtype), self.weight.to(dtype), _as(self.bias, dtype),
                          stride=self.stride, padding=self.padding, dilation=self.dilation)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor, dtype=F32) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), _as(self.bias, dtype))
