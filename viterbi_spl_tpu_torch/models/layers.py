"""Layers the port's models share, with flax.linen's numerics in PyTorch's
NCHW layout.

- `BatchNorm`: flax BatchNorm over the channel axis (dim 1), epsilon 1e-5.
  In eval mode it normalizes by its running averages, or
  (`batch_stats=True`) by the input batch's own mean and biased variance
  without touching the averages (the apps' eval_batch_stats forward). In
  training mode (`model.train()`, flax's train=True) it normalizes by the
  batch and, outside autograd, updates the averages as flax does with its
  default momentum 0.99: mean <- 0.99 mean + 0.01 mu_B and var <- 0.99 var
  + 0.01 sigma^2_B, sigma^2_B the biased variance it normalized with.
  (torch's BatchNorm2d keeps momentum 0.1 and an unbiased running
  variance, so it is not used.) The variance is E[(x - E[x])^2], two
  passes. flax 0.12's default is E[x^2] - E[x]^2, which cancels where the
  variance is small against the mean's square: the SF modules normalize
  chunk means across a track's chunks, and on such means (variance 1.8e-6
  of the square) flax's float32 output is 0.012 off float64, the two-pass
  one 3.5e-5 (scripts/precision_probe.py). The result is at least float32
  where the layer has a scale or a bias (flax promotes to the params'
  dtype), else the input's dtype.
- `LayerNorm`: flax LayerNorm over the last axis (the same variance rule).
- `Dropout`: flax's nn.Dropout in training mode: each value kept with
  probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
  the torch.Generator the forward is given (on the input's device). Off in
  eval mode, and off without a generator (how the tests hold a training
  step against the JAX package's with its dropouts intercepted).
- Data shares (`data_share`): a `--mesh` train step runs each share of the
  global batch on its own replica, one thread a share
  (dist/train.py::ShareGroup). Inside `data_share(group, i)` BatchNorm
  takes the statistics of the global batch: the shares' sums are reduced
  across the group (in-process and across processes), then, from the
  global mean, their sums of squared deviations, before any share
  normalizes; the reductions are differentiable, so the backward sees the
  global statistics too, and every replica moves its running averages by
  the same global mean and variance. Dropout draws the mask of the global
  batch (every share's generator is seeded alike) and keeps its share's
  rows, so that the masks equal the single-device run's. Both read dim 0
  as the batch, as every model here lays it out.
- `Conv` / `Dense`: a convolution or a dense layer that runs in the compute
  dtype it is given (float32, or bfloat16 under mixed precision) with
  float32 params, as flax's `dtype=` does. `padding="same"` pads as XLA
  does (the odd pad on the high side, for any stride), "valid" not at all;
  `dilation` as flax's `kernel_dilation`.
- `at_least_f32`: bfloat16 or float16 to float32, float32 and float64 as
  they are: the models' "back to float32" after a low-precision layer,
  which keeps a float64 model (the tests' reference runs) in float64.

Initializers follow flax's: kernels lecun_normal (a normal truncated at two
standard deviations, variance 1 / fan_in), or he_normal (variance 2 /
fan_in) where the JAX module sets it (`kernel_init="he"`); biases, norm
offsets and running means 0, norm scales and running variances 1.
`init_params(model, generator)` draws every layer of a model, in module
order, from one generator (apps/common.py::init_model passes a seeded CPU
one, so that every device gets the same weights).

Params use PyTorch's layouts (OIHW kernels, [out, in] dense weights);
models/convert.py carries flax's across.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

F32 = torch.float32
BN_MOMENTUM = 0.99
# flax's truncated_normal variance_scaling divides the standard deviation
# by the std of a unit normal truncated at +/-2
_TRUNC_STD = 0.87962566103423978


def _as(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32) if x.dtype in (torch.bfloat16, torch.float16) else x


def variance_scaling_(w: torch.Tensor, fan_in: int, scale: float = 1.0, generator=None):
    """flax's variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


_KERNEL_SCALE = {"lecun": 1.0, "he": 2.0}

_SHARE = threading.local()


@contextlib.contextmanager
def data_share(group, index: int):
    """This thread runs share `index` of `group` (dist/train.py::ShareGroup:
    `all_reduce(index, t)`, `size` the global number of shares,
    `global_index(index)`) until the block ends."""
    prev = getattr(_SHARE, "value", None)
    _SHARE.value = (group, index)
    try:
        yield
    finally:
        _SHARE.value = prev


def current_share():
    """(group, index) of the data share this thread runs, or None."""
    return getattr(_SHARE, "value", None)


def init_params(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Every layer's params and statistics drawn anew, in module order, from
    `generator` (the global one when None)."""
    for m in model.modules():
        if hasattr(m, "draw_params"):
            m.draw_params(generator)
    return model


class BatchNorm(nn.Module):
    def __init__(self, n: int, use_scale: bool = True, use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(n)) if use_bias else None
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def draw_params(self, generator=None):
        with torch.no_grad():
            for t, v in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
                if t is not None:
                    t.fill_(v)

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        xf = at_least_f32(x)
        if self.training or batch_stats:
            axes = [d for d in range(x.ndim) if d != 1]
            share = current_share()
            if share is None:
                mu = xf.mean(dim=axes)
                var = ((xf - mu.view(shape)) ** 2).mean(dim=axes)
            else:  # the global batch's statistics (see the module docstring)
                group, i = share
                n = xf.numel() // xf.shape[1] * group.size
                mu = group.all_reduce(i, xf.sum(dim=axes)) / n
                var = group.all_reduce(i, ((xf - mu.view(shape)) ** 2).sum(dim=axes)) / n
            if self.training:
                with torch.no_grad():
                    self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mu)
                    self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
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

    def draw_params(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        return (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or generator is None or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        share = current_share()
        if share is None:
            draw = torch.rand(x.shape, generator=generator, device=x.device)
        else:  # this share's rows of the global batch's mask
            group, i = share
            b, first = x.shape[0], group.global_index(i) * x.shape[0]
            draw = torch.rand((b * group.size, *x.shape[1:]), generator=generator,
                              device=x.device)[first:first + b]
        keep = draw < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _xla_same_pads(sizes, kernel, stride, dilation) -> list[int]:
    """XLA's SAME padding for a strided, dilated convolution, as F.pad's
    list (last dim first): out = ceil(n / s), the odd pad on the high side."""
    pads = []
    for n, k, s, d in zip(reversed(sizes), reversed(kernel), reversed(stride), reversed(dilation)):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class Conv(nn.Module):
    """A 1-D or 2-D convolution (len(kernel) says which) in the compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding: str = "same",
                 bias: bool = True, dilation=1, kernel_init: str = "lecun"):
        super().__init__()
        kernel = tuple(kernel)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self._conv = F.conv1d if len(kernel) == 1 else F.conv2d
        n = len(kernel)
        self._strided_same = padding == "same" and any(s != 1 for s in _tuple(stride, n))
        self.draw_params()

    def draw_params(self, generator=None):
        fan_in = self.weight.shape[1] * math.prod(self.weight.shape[2:])
        variance_scaling_(self.weight, fan_in, _KERNEL_SCALE[self.kernel_init], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype=F32) -> torch.Tensor:
        padding = self.padding
        if self._strided_same:
            n = self.weight.ndim - 2
            x = F.pad(x, _xla_same_pads(x.shape[2:], self.weight.shape[2:],
                                        _tuple(self.stride, n), _tuple(self.dilation, n)))
            padding = "valid"
        return self._conv(x.to(dtype), self.weight.to(dtype), _as(self.bias, dtype),
                          stride=self.stride, padding=padding, dilation=self.dilation)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, kernel_init: str = "lecun"):
        super().__init__()
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.draw_params()

    def draw_params(self, generator=None):
        variance_scaling_(self.weight, self.weight.shape[1], _KERNEL_SCALE[self.kernel_init],
                          generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype=F32) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), _as(self.bias, dtype))
