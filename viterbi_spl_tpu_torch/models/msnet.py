"""MSNet (Hsieh's encoder/decoder melody extractor) in PyTorch (counterpart
of viterbi_spl_tpu/models/msnet.py).

Architecture parity with msnet/acoustic_model_correct.py:9-138:
- encoder: 3 x [BatchNorm(no scale/center) -> 5x5 SELU conv (no bias,
  32/64/128 ch) -> 1x4 max-pool over frequency with argmax],
- non-melody head: BatchNorm(center) -> time pad [2,2] -> 5x5 VALID conv
  -> one logit per frame,
- decoder: mirror with argmax UNpooling (scatter back to the argmax
  positions), SELU convs 64/32 ch, final BatchNorm(center) + 5x5 conv to 1,
- concat non-melody + 320 decoder bins on the frequency axis ->
  [B, T, 321] softmax logits (class 0 = non-melody).

Layout: NCHW with H = time and W = frequency ([B, C, T, F]), the JAX
module's NHWC [B, T, F, C] with the channel axis moved. The pool takes the
first maximum of each group of 4 (reshape + argmax) and the unpool is a
one-hot scatter, as the JAX module does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import F32, BatchNorm, Conv, at_least_f32


def max_pool_freq4_argmax(x):
    """[B, C, T, F] -> ([B, C, T, F//4] pooled, in-group argmax (the first
    maximum) [B, C, T, F//4])."""
    B, C, T, Fr = x.shape
    g = x.reshape(B, C, T, Fr // 4, 4)
    return g.amax(dim=-1), g.argmax(dim=-1)


def unpool_freq4(x, idx, F_out: int):
    """Inverse of max_pool_freq4_argmax: each value back to its argmax slot
    within the group of 4 (other slots zero)."""
    B, C, T, Fp = x.shape
    onehot = F.one_hot(idx, 4).to(x.dtype)  # [B, C, T, Fp, 4]
    return (x[..., None] * onehot).reshape(B, C, T, Fp * 4)[..., :F_out]


class MSNet(nn.Module):
    def __init__(self, n_bins: int = 320, dtype=F32):
        super().__init__()
        self.n_bins, self.dtype = n_bins, dtype
        self.enc_bn = nn.ModuleList(BatchNorm(c, use_scale=False, use_bias=False)
                                    for c in (3, 32, 64))
        self.enc_conv = nn.ModuleList(Conv(i, o, (5, 5), bias=False)
                                      for i, o in ((3, 32), (32, 64), (64, 128)))
        self.nm_bn = BatchNorm(128, use_scale=False)
        self.nm_conv = Conv(128, 1, (5, 5), padding="valid")
        # decoder layers 2 and 1 (no scale, no bias), then layer 0
        self.dec_bn = nn.ModuleList([BatchNorm(32, use_scale=False),
                                     BatchNorm(64, use_scale=False, use_bias=False),
                                     BatchNorm(128, use_scale=False, use_bias=False)])
        self.dec_conv = nn.ModuleList([Conv(32, 1, (5, 5)),
                                       Conv(64, 32, (5, 5), bias=False),
                                       Conv(128, 64, (5, 5), bias=False)])

    def forward(self, x, batch_stats: bool = False, dropout=None):
        """x [B, T, 320, 3] -> [B, T, 321] (no dropout: `dropout` is taken
        for the models' common signature). (The JAX module's valid_frames
        masks bucket padding, which its compiled shapes need; the port runs
        a ragged snippet at its own length instead.)"""
        if x.ndim != 4 or x.shape[2] != self.n_bins:
            raise ValueError(f"expected [B, T, {self.n_bins}, 3], got {tuple(x.shape)}")
        dt = self.dtype
        h = x.permute(0, 3, 1, 2)  # [B, 3, T, F]
        argmaxes = []
        for bn, conv in zip(self.enc_bn, self.enc_conv):
            h = F.selu(conv(bn(h, batch_stats), dt))
            h, idx = max_pool_freq4_argmax(h)
            argmaxes.append(idx)
        encoder_out = h  # [B, 128, T, 5]

        nm = self.nm_bn(encoder_out, batch_stats)
        nm = self.nm_conv(F.pad(nm, (0, 0, 2, 2)), dt)  # [B, 1, T, 1]

        h = encoder_out
        for layer in (2, 1, 0):
            h = unpool_freq4(h, argmaxes[layer], self.n_bins // (4 ** layer))
            h = self.dec_conv[layer](self.dec_bn[layer](h, batch_stats), dt)
            if layer > 0:
                h = F.selu(h)
        return torch.cat([at_least_f32(nm), at_least_f32(h)], dim=3)[:, 0]  # [B, T, 321]
