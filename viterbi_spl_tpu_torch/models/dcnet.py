"""DCNet ("shaun"), the dilated-CNN melody extractor, in PyTorch (counterpart
of viterbi_spl_tpu/models/dcnet.py).

Architecture parity with dcnet/acoustic_model_shaun.py:23-91:
- input [B, T, 500] NSGT feature,
- "local" stack: 4 conv layers over (time, freq), 16 channels, kernel
  [5,5] then [3,5], time-dilation 2^layer, SAME padding, no bias, each
  followed by BatchNorm(scale=False) + ReLU (+ dropout 0.2 from layer 1),
- "global" layer: freq pad [240, 60] then a [1, 97] conv with freq-dilation
  5 (VALID) -> 128 channels over exactly 320 output bins, BN + ReLU + drop,
- fusion dense 64 (no bias) + BN + ReLU + drop, output dense 1 (bias),
- squeeze -> [B, T, 320] sigmoid logits.

Trained with per-bin BCE (targets.dcnet_loss) and manual weight decay 2e-4
on the global conv kernel only (`global_conv_kernel_name`, the trainer's
add_weight_decay_grad).

Layout: NCHW with H = time and W = frequency ([B, C, T, F]), the JAX
module's NHWC [B, T, F, C] with the channel axis moved, so that a flax
HWIO kernel maps to OIHW by one transpose. The denses run over the channel
axis moved last. `model.train()` is the JAX module's train=True (BatchNorm
by the batch, its averages updated; the dropouts draw from the `dropout`
generator, and are off without one). The JAX module's valid_frames masks
bucket padding, which its compiled shapes need; the port runs a ragged
snippet at its own length instead.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import F32, BatchNorm, Conv, Dense, Dropout, at_least_f32


class DCNet(nn.Module):
    def __init__(self, n_freq_in: int = 500, n_bins: int = 320, dropout_rate: float = 0.2,
                 dtype=F32):
        super().__init__()
        self.n_freq_in, self.n_bins, self.dtype = n_freq_in, n_bins, dtype
        self.local_conv = nn.ModuleList(
            Conv(1 if i == 0 else 16, 16, (5, 5) if i == 0 else (3, 5), bias=False,
                 dilation=(2 ** i, 1))
            for i in range(4))
        self.local_bn = nn.ModuleList(BatchNorm(16, use_scale=False) for _ in range(4))
        self.global_conv = Conv(16, 128, (1, 97), padding="valid", bias=False, dilation=(1, 5))
        self.global_bn = BatchNorm(128, use_scale=False)
        self.fusion_dense = Dense(128, 64, bias=False)
        self.fusion_bn = BatchNorm(64, use_scale=False)
        self.output_dense = Dense(64, 1)
        self.drop = Dropout(dropout_rate)

    @staticmethod
    def global_conv_kernel_name() -> str:
        """The parameter that receives manual weight decay (the reference's
        locate_global_kernel_fn targets the 1x97 conv,
        dcnet/softmax_viterbi.py:293-322; the JAX module's
        global_conv_kernel_path)."""
        return "global_conv.weight"

    def forward(self, x, batch_stats: bool = False, dropout: torch.Generator | None = None):
        """x [B, T, 500] -> [B, T, 320] float32 logits."""
        if x.ndim != 3 or x.shape[-1] != self.n_freq_in:
            raise ValueError(f"expected [B, T, {self.n_freq_in}], got {tuple(x.shape)}")
        dt = self.dtype
        h = x[:, None]  # [B, 1, T, F]
        for i, (conv, bn) in enumerate(zip(self.local_conv, self.local_bn)):
            h = F.relu(bn(conv(h, dt), batch_stats))
            if i > 0:
                h = self.drop(h, dropout)
        # global context: freq pad [240, 60], kernel width 97 with dilation 5
        h = self.global_conv(F.pad(h, (240, 60)), dt)
        if h.shape[3] != self.n_bins:
            raise AssertionError(f"global conv produced {h.shape[3]} bins")
        h = self.drop(F.relu(self.global_bn(h, batch_stats)), dropout)
        h = self.fusion_dense(h.movedim(1, -1), dt)  # [B, T, 320, 64]
        h = self.drop(F.relu(self.fusion_bn(h.movedim(-1, 1), batch_stats)), dropout)
        h = self.output_dense(h.movedim(1, -1), dt)
        return at_least_f32(h[..., 0])  # [B, T, 320]
