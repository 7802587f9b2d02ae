"""JDC (Kum and Nam, "Joint Detection and Classification of Singing Voice
Melody Using Convolutional Recurrent Neural Networks", Applied Sciences
9(7):1324, 2019; the reference code's jdc/acoustic_module.py:8-85) in plain
PyTorch, float32, inference only.

A frozen copy with the parameter names of the measured program's module
tree, so that one set of benchmark-made weights loads strictly into both.
Layout [B, 31, 513] in (a chunk of 31 frames of the 513-bin spectrogram),
dict(pitch [B, 31, 722], voicing [B, 31]) out, class 0 of the pitch head
the non-melody class.

- Conv block: 3x3 conv to 64, BatchNorm, LeakyReLU(0.01), 3x3 conv.
- Three ResNet blocks of 128, 192, 256 channels, each opened by BatchNorm,
  LeakyReLU and a 1x4 max-pool over frequency (513 -> 128 -> 32 -> 8); a
  1x1 conv beside two 3x3 convs with BatchNorm and LeakyReLU between them.
- Pitch head: BatchNorm, LeakyReLU, 1x4 pool (8 -> 2), [B, 31, 512], a
  BiLSTM of 256 a direction, a dense layer to 722.
- Voicing head: the four blocks' outputs max-pooled to width 2 and
  concatenated (64 + 128 + 192 + 256), a 1x1 conv to 256, BatchNorm,
  LeakyReLU, a BiLSTM of 32 a direction, a dense layer to 2 and a softmax,
  added to (the pitch head's non-melody mass, the rest); the output is
  voiced minus unvoiced.

Each LSTM is written out as its gate equations: gates = W_ih x_t + b_ih +
W_hh h_{t-1} + b_hh, split as (i, f, g, o); c_t = sigmoid(f) c_{t-1} +
sigmoid(i) tanh(g), h_t = sigmoid(o) tanh(c_t); one loop over the frames
forward and one over them backward (the backward's outputs in the frames'
order), concatenated. No nn.LSTM and no cuDNN RNN.

Departures from the published description, each the measured program's:
- BatchNorm has flax's epsilon 1e-5 (Keras's default is 1e-3) and runs on
  its running averages.
- The LSTM gates take the logistic sigmoid (Keras 2.2's default recurrent
  activation is the hard sigmoid); the one bias sits in b_hh, b_ih zero.
- The pitch head returns logits: the published model's softmax is left
  out, which moves every logit of a frame alike and so no re-referenced
  logit (pitch[..., 1:] - pitch[..., :1]).
- No dropout (inference) and no l2 regularizer (training only).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..traffic import sub_seed
from ..weights import make_weights
from .tonet import BatchNorm, Dense


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _pool14(x):
    return F.max_pool2d(x, (1, 4), (1, 4))


def _to_btf(x):
    """[B, C, T, W] -> [B, T, W * C], channels fastest."""
    B, C, T, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, T, W * C)


class Conv(nn.Module):
    """A 2-D convolution with no bias, padded "same" (odd kernels here)."""

    def __init__(self, c_in, c_out, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))

    def forward(self, x):
        return F.conv2d(x, self.weight, padding="same")


class ResNetBlock(nn.Module):
    def __init__(self, c_in, filters):
        super().__init__()
        self.pre_bn = BatchNorm(c_in)
        self.conv_1x1 = Conv(c_in, filters, (1, 1))
        self.conv_1 = Conv(c_in, filters, (3, 3))
        self.mid_bn = BatchNorm(filters)
        self.conv_2 = Conv(filters, filters, (3, 3))

    def forward(self, x):
        h = _pool14(_lrelu(self.pre_bn(x)))
        return self.conv_1x1(h) + self.conv_2(_lrelu(self.mid_bn(self.conv_1(h))))


class LSTMWeights(nn.Module):
    """The weights of one bidirectional LSTM layer, under nn.LSTM's names."""

    def __init__(self, d_in, hidden):
        super().__init__()
        for suffix in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{suffix}",
                                    nn.Parameter(torch.empty(4 * hidden, d_in)))
            self.register_parameter(f"weight_hh_l0{suffix}",
                                    nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l0{suffix}", nn.Parameter(torch.zeros(4 * hidden)))
            self.register_parameter(f"bias_hh_l0{suffix}", nn.Parameter(torch.zeros(4 * hidden)))


def lstm_direction(x, w_ih, w_hh, b_ih, b_hh, reverse: bool):
    """[B, T, D] -> [B, T, H], the gate equations frame by frame."""
    B, T, _ = x.shape
    H = w_hh.shape[1]
    inputs = F.linear(x, w_ih, b_ih)  # every frame's W_ih x_t + b_ih at once
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (inputs[:, t] + F.linear(h, w_hh, b_hh)).chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


class BiLSTM(nn.Module):
    def __init__(self, d_in, hidden):
        super().__init__()
        self.lstm = LSTMWeights(d_in, hidden)

    def forward(self, x):
        w = self.lstm
        return torch.cat([
            lstm_direction(x, w.weight_ih_l0, w.weight_hh_l0, w.bias_ih_l0, w.bias_hh_l0, False),
            lstm_direction(x, w.weight_ih_l0_reverse, w.weight_hh_l0_reverse,
                           w.bias_ih_l0_reverse, w.bias_hh_l0_reverse, True),
        ], dim=-1)


class JDC(nn.Module):
    def __init__(self, n_pitch_classes: int = 722):
        super().__init__()
        self.conv1_1 = Conv(1, 64, (3, 3))
        self.bn1 = BatchNorm(64)
        self.conv1_2 = Conv(64, 64, (3, 3))
        self.block2 = ResNetBlock(64, 128)
        self.block3 = ResNetBlock(128, 192)
        self.block4 = ResNetBlock(192, 256)
        self.bn4 = BatchNorm(256)
        self.pitch_lstm = BiLSTM(512, 256)
        self.pitch_dense = Dense(512, n_pitch_classes)
        self.v_conv = Conv(64 + 128 + 192 + 256, 256, (1, 1))
        self.v_bn = BatchNorm(256)
        self.v_lstm = BiLSTM(512, 32)
        self.v_dense = Dense(64, 2)

    def forward(self, x):
        b1 = self.conv1_2(_lrelu(self.bn1(self.conv1_1(x[:, None]))))  # [B, 64, T, 513]
        b2 = self.block2(b1)  # [B, 128, T, 128]
        b3 = self.block3(b2)  # [B, 192, T, 32]
        b4 = self.block4(b3)  # [B, 256, T, 8]
        b4p = _pool14(_lrelu(self.bn4(b4)))  # [B, 256, T, 2]
        pitch = self.pitch_dense(self.pitch_lstm(_to_btf(b4p)))

        pooled = [F.max_pool2d(b, (1, 4 ** k), (1, 4 ** k)) for b, k in ((b1, 4), (b2, 3), (b3, 2))]
        v = _lrelu(self.v_bn(self.v_conv(torch.cat(pooled + [b4p], dim=1))))
        v = torch.softmax(self.v_dense(self.v_lstm(_to_btf(v))), dim=-1)
        p_nonvoice = torch.softmax(pitch, dim=-1)[..., 0]
        v = v + torch.stack([p_nonvoice, 1.0 - p_nonvoice], dim=-1)
        return dict(pitch=pitch, voicing=v[..., 1] - v[..., 0])


def pitch_logits(out: dict) -> torch.Tensor:
    """The re-referenced pitch logits the decode takes: [..., 721]."""
    return out["pitch"][..., 1:] - out["pitch"][..., :1]


def jdc_weights(seed: int, device) -> dict:
    """make_weights(JDC) with the LSTMs' kernels, the BatchNorm averages,
    scales and offsets, and the biases drawn too.

    make_weights draws the parameters named "weight"; nn.LSTM names its
    kernels weight_ih_l0, weight_hh_l0 (and _reverse), which it would leave
    at zero, and a zero LSTM outputs zeros whatever its input. They are
    drawn as make_weights draws a kernel (a normal truncated at two
    standard deviations, over sqrt(fan_in), fan_in the kernel's second
    dimension, flax's lecun_normal), from the seed's own stream.

    make_weights leaves every BatchNorm at mean 0, variance 1, scale 1 and
    offset 0, and every bias at 0, where a comparison cannot tell a program
    that drops one of them. From the same stream: running means and
    offsets 0.1 N(0, 1), variances and scales uniform on [0.5, 1.5), the
    dense layers' biases and the LSTMs' bias_hh 0.1 N(0, 1); bias_ih stays
    0, as the program keeps it."""
    with torch.device("meta"):
        model = JDC()
    out = make_weights(model, seed, device)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 9))
    kernels = [k for k in out if k.rsplit(".", 1)[-1].startswith(("weight_ih", "weight_hh"))]
    for k in kernels:
        shape = out[k].shape
        draw = torch.randn(shape, generator=g, device=device).clamp_(-2.0, 2.0)
        out[k] = draw.mul_(0.87962566103423978 ** -1 / shape[1] ** 0.5)
    for k, v in out.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("var", "scale"):
            out[k] = torch.rand(v.shape, generator=g, device=device).add_(0.5)
        elif leaf in ("mean", "bias") or leaf.startswith("bias_hh"):
            out[k] = torch.randn(v.shape, generator=g, device=device).mul_(0.1)
    return out
