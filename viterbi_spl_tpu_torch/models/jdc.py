"""JDC (Kum's joint detection & classification network) in PyTorch
(counterpart of viterbi_spl_tpu/models/jdc.py).

Architecture parity with jdc/acoustic_module.py:8-85:
- conv block (64ch, two 3x3 convs) + 3 ResNet blocks (128/192/256) each
  preceded by BN + LeakyReLU(0.01) + 1x4 freq max-pool,
- pitch head: BN/LReLU/1x4-pool/dropout 0.5 -> reshape [B, 31, 512] ->
  BiLSTM(256) -> Dense 722 logits (class 0 = non-melody),
- voicing head: multi-scale concat of the pooled blocks -> 1x1 conv 256 ->
  BN/LReLU/dropout 0.5 -> reshape -> BiLSTM(32) -> Dense 2 softmax,
  COMBINED with the pitch-derived voicing (softmax mass off class 0); the
  output voicing logit is voiced-minus-unvoiced of the combined
  distribution,
- the reference's l2(1e-5) regularizer on the first convs and the 1x1
  voicing conv: `l2_param_names`, for the trainer's l2_regularization.
The convs are he_normal-initialized, as the JAX module's.

Layout: NCHW with H = time and W = frequency ([B, C, T, F]). The BiLSTMs
are nn.LSTM(bidirectional=True): flax's OptimizedLSTMCell has the same
gates in the same order (i, f, g, o), its input kernels carry no bias and
its hidden kernels do, so the bias sits in bias_hh and bias_ih is zero;
the reverse direction runs over the reversed sequence and returns in the
original order (flax's reverse=True, keep_order=True). bias_ih takes no
gradient (frozen at zero), so that the one bias trains as flax's does; the
initializers are flax's (input kernels lecun_normal, hidden kernels
orthogonal, biases zero). `model.train()` is the JAX module's train=True;
the dropouts draw from the `dropout` generator, and are off without one.

Spans (tracing.py): `model.convs`, from the first conv to the pooled
block 4, and `model.recurrent` around each BiLSTM (attr `head`: `pitch`
or `voicing`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from .. import tracing
from .layers import F32, BatchNorm, Conv, Dense, Dropout, at_least_f32, variance_scaling_


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _pool14(x):
    return F.max_pool2d(x, (1, 4), (1, 4))


def _to_btf(x):
    """[B, C, T, W] -> [B, T, W * C] (the JAX module's NHWC reshape)."""
    B, C, T, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, T, W * C)


class ResNetBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.pre_bn = BatchNorm(c_in)
        self.conv_1x1 = Conv(c_in, filters, (1, 1), bias=False, kernel_init="he")
        self.conv_1 = Conv(c_in, filters, (3, 3), bias=False, kernel_init="he")
        self.mid_bn = BatchNorm(filters)
        self.conv_2 = Conv(filters, filters, (3, 3), bias=False, kernel_init="he")

    def forward(self, x, batch_stats: bool = False):
        dt = self.dtype
        h = _pool14(_lrelu(self.pre_bn(x, batch_stats)))
        init = self.conv_1x1(h, dt)
        h = self.conv_2(_lrelu(self.mid_bn(self.conv_1(h, dt), batch_stats)), dt)
        return at_least_f32(init) + at_least_f32(h)


class BiLSTM(nn.Module):
    """Bidirectional LSTM over the time axis, [B, T, D] -> [B, T, 2 H]."""

    def __init__(self, d_in: int, features: int, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.lstm = nn.LSTM(d_in, features, batch_first=True, bidirectional=True)
        for suffix in ("", "_reverse"):
            getattr(self.lstm, f"bias_ih_l0{suffix}").requires_grad_(False)
        self.draw_params()

    def draw_params(self, generator=None):
        H = self.lstm.hidden_size
        with torch.no_grad():
            for suffix in ("", "_reverse"):
                w_ih = getattr(self.lstm, f"weight_ih_l0{suffix}")
                variance_scaling_(w_ih, w_ih.shape[1], generator=generator)
                w_hh = getattr(self.lstm, f"weight_hh_l0{suffix}")
                for g in range(4):  # one orthogonal kernel a gate
                    nn.init.orthogonal_(w_hh[g * H:(g + 1) * H], generator=generator)
                getattr(self.lstm, f"bias_ih_l0{suffix}").zero_()
                getattr(self.lstm, f"bias_hh_l0{suffix}").zero_()

    def forward(self, x):
        if self.dtype == self.lstm.weight_ih_l0.dtype:
            return self.lstm(x.to(self.dtype))[0]
        params = {k: v.to(self.dtype) for k, v in self.lstm.named_parameters()}
        return functional_call(self.lstm, params, (x.to(self.dtype),))[0]


class JDC(nn.Module):
    def __init__(self, n_pitch_classes: int = 722, chunk_len: int = 31, dtype=F32):
        super().__init__()
        self.chunk_len, self.dtype = chunk_len, dtype
        self.conv1_1 = Conv(1, 64, (3, 3), bias=False, kernel_init="he")
        self.bn1 = BatchNorm(64)
        self.conv1_2 = Conv(64, 64, (3, 3), bias=False, kernel_init="he")
        self.block2 = ResNetBlock(64, 128, dtype)
        self.block3 = ResNetBlock(128, 192, dtype)
        self.block4 = ResNetBlock(192, 256, dtype)
        self.bn4 = BatchNorm(256)
        self.pitch_lstm = BiLSTM(512, 256, dtype)
        self.pitch_dense = Dense(512, n_pitch_classes)
        self.v_conv = Conv(64 + 128 + 192 + 256, 256, (1, 1), bias=False, kernel_init="he")
        self.v_bn = BatchNorm(256)
        self.v_lstm = BiLSTM(512, 32, dtype)
        self.v_dense = Dense(64, 2)
        self.drop = Dropout(0.5)

    @staticmethod
    def l2_param_names() -> tuple[str, ...]:
        """Kernels carrying the reference's l2(1e-5) regularizer (the JAX
        module's l2_param_paths)."""
        return ("conv1_1.weight", "conv1_2.weight", "v_conv.weight")

    def forward(self, x, batch_stats: bool = False, dropout: torch.Generator | None = None):
        """x [B, 31, 513] -> dict(pitch [B, 31, 722], voicing [B, 31])."""
        if x.ndim != 3:
            raise ValueError(f"expected [B, T, 513], got {tuple(x.shape)}")
        dt = self.dtype
        h = x[:, None]  # [B, 1, T, F]
        with tracing.span("model.convs"):
            b1 = self.conv1_1(h, dt)
            b1 = at_least_f32(self.conv1_2(_lrelu(self.bn1(b1, batch_stats)), dt))
            b2 = self.block2(b1, batch_stats)
            b3 = self.block3(b2, batch_stats)
            b4 = self.block4(b3, batch_stats)  # [B, 256, T, 8]
            b4p = _pool14(_lrelu(self.bn4(b4, batch_stats)))  # [B, 256, T, 2]
        b4p = self.drop(b4p, dropout)

        pitch = _to_btf(b4p)
        with tracing.span("model.recurrent", head="pitch"):
            pitch = self.pitch_lstm(pitch)
        pitch = at_least_f32(self.pitch_dense(pitch, dt))

        v1 = F.max_pool2d(b1, (1, 4 ** 4), (1, 4 ** 4))
        v2 = F.max_pool2d(b2, (1, 4 ** 3), (1, 4 ** 3))
        v3 = F.max_pool2d(b3, (1, 4 ** 2), (1, 4 ** 2))
        voicing = torch.cat([v1, v2, v3, b4p], dim=1)
        voicing = _lrelu(self.v_bn(self.v_conv(voicing, dt), batch_stats))
        voicing = _to_btf(self.drop(voicing, dropout))
        with tracing.span("model.recurrent", head="voicing"):
            voicing = self.v_lstm(voicing)
        voicing = torch.softmax(at_least_f32(self.v_dense(voicing, dt)), dim=-1)

        # combine with pitch-derived voicing (jdc/acoustic_module.py:74-81)
        p_nonvoice = torch.softmax(pitch, dim=-1)[..., 0]
        voicing = voicing + torch.stack([p_nonvoice, 1.0 - p_nonvoice], dim=-1)
        return dict(pitch=pitch, voicing=voicing[..., 1] - voicing[..., 0])
