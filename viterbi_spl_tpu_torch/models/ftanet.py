"""FTANet (Yu's frequency/time-attention network) in PyTorch (counterpart of
viterbi_spl_tpu/models/ftanet.py).

Architecture parity with ftanet/acoustic_model.py:13-129:
- input [B, 128, 320, 3] CFP snippets, transposed to (freq, time) layout,
- bottom branch: strided (4,1) SELU convs collapsing 320 freq bins -> 1
  non-melody row,
- U-shape: FTA modules (residual 1x1 conv + time attention + freq
  attention) fused by SF modules (selective-kernel fusion with a softmax
  over the CHANNEL axis, exactly as the reference code does), channels
  32 -> 64 -> 128 with 2x2 max-pool down and 2x2 nearest upsampling,
- concat non-melody row + 320-bin map -> [B, 128, 321] softmax logits
  (class 0 = non-melody).

Layout: NCHW with H = frequency and W = time ([B, C, F, T]), the JAX
module's NHWC [B, F, T, C] with the channel axis moved. `batch_stats=True`
normalizes by the batch's own statistics (the JAX package's eval_batch_stats
forward, flax train=True with its updates discarded); `model.train()` is
flax's train=True (the batch's statistics, the running averages updated). `dtype` is the compute
dtype of the convs and denses; params, BatchNorm, the attention softmaxes
and the returned logits stay float32.

TONet's 360-bin backbone (models/tonet.py::TorchFTAnet) is this network
with other bottom-branch strides.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import F32, BatchNorm, Conv, Dense, at_least_f32


class SFModule(nn.Module):
    """Selective-kernel fusion (ftanet/acoustic_model.py:13-44): average
    pool -> BatchNorm -> Dense + SELU -> one mask per branch, softmax over
    the channel axis."""

    def __init__(self, n_channel: int, n_branches: int = 3, reduction: int = 4,
                 limitation: int = 4, dtype=F32):
        super().__init__()
        self.dtype = dtype
        hidden = max(n_channel // reduction, limitation)
        self.bn = BatchNorm(n_channel)
        self.fuse = Dense(n_channel, hidden)
        self.masks = nn.ModuleList(Dense(hidden, n_channel) for _ in range(n_branches))

    def forward(self, x_list, batch_stats: bool = False):
        dt = self.dtype
        fused = sum(x_list).mean(dim=(2, 3))  # [B, C]
        fused = F.selu(self.fuse(self.bn(fused, batch_stats), dt))
        mask = torch.stack([m(fused, dt) for m in self.masks], dim=-1)  # [B, C, K]
        mask = torch.softmax(at_least_f32(mask), dim=-2).to(dt)
        out = 0.0
        for i, x_s in enumerate(x_list):
            out = out + x_s * mask[:, :, i, None, None]
        return out


class FTAModule(nn.Module):
    """Residual + time-attention + freq-attention branches
    (ftanet/acoustic_model.py:47-77). Input [B, C_in, F, T] -> three
    [B, C_out, F, T] branches."""

    def __init__(self, c_in: int, out_channels: int, kt: int = 3, kf: int = 3, dtype=F32):
        super().__init__()
        C = out_channels
        self.dtype = dtype
        self.bn = BatchNorm(c_in)
        self.res = Conv(c_in, C, (1, 1))
        self.ta1, self.ta2 = Conv(c_in, C, (kt,)), Conv(C, C, (kt,))
        self.t3, self.t5 = Conv(c_in, C, (3, 3)), Conv(C, C, (5, 5))
        self.fa1, self.fa2 = Conv(c_in, C, (kf,)), Conv(C, C, (kf,))
        self.f3, self.f5 = Conv(c_in, C, (3, 3)), Conv(C, C, (5, 5))

    def forward(self, x, batch_stats: bool = False):
        dt = self.dtype
        x = self.bn(x, batch_stats)
        x_r = F.relu(self.res(x, dt))

        # time attention: mean over freq -> [B, C_in, T], softmax over time
        a_t = F.selu(self.ta2(F.selu(self.ta1(x.mean(dim=2), dt)), dt))
        a_t = torch.softmax(at_least_f32(a_t), dim=-1).to(dt)
        x_t = F.selu(self.t5(F.selu(self.t3(x, dt)), dt)) * a_t[:, :, None, :]

        # frequency attention: mean over time -> [B, C_in, F], softmax over freq
        a_f = F.selu(self.fa2(F.selu(self.fa1(x.mean(dim=3), dt)), dt))
        a_f = torch.softmax(at_least_f32(a_f), dim=-1).to(dt)
        x_f = F.selu(self.f5(F.selu(self.f3(x, dt)), dt)) * a_f[:, :, :, None]
        return x_r, x_t, x_f


def _maxpool22(x):
    return F.max_pool2d(x, 2, 2)


def _upsample22(x):
    """2x2 nearest upsampling: each value repeated, not interpolated."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FTAUNet(nn.Module):
    """The U-net both FTANet and TONet's backbone are: [B, 3, F, T] ->
    [B, F + 1, T] float32, the non-melody row first. `bm_kernels` are the
    bottom branch's (channels, frequency stride) steps."""

    def __init__(self, freq_bin: int, bm_kernels, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.in_bn = BatchNorm(3)
        c_in, bm = 3, []
        for ch, k in bm_kernels:
            bm.append(Conv(c_in, ch, (k, 1), stride=(k, 1), padding="valid"))
            c_in = ch
        self.bm = nn.ModuleList(bm)
        chans = (32, 64, 128, 128, 64, 32, 1)
        ins = (3,) + chans[:-1]
        self.fta = nn.ModuleList(FTAModule(i, c, dtype=dtype) for i, c in zip(ins, chans))
        self.sf = nn.ModuleList(SFModule(c, dtype=dtype) for c in chans)

    def forward(self, x, batch_stats: bool = False):
        dt = self.dtype
        x = self.in_bn(x, batch_stats)
        bm = x
        for conv in self.bm:
            bm = F.selu(conv(bm, dt))  # -> [B, 1, 1, T]

        def fta_sf(h, i):
            return self.sf[i](self.fta[i](h, batch_stats), batch_stats)

        h = _maxpool22(fta_sf(x, 0))
        h = _maxpool22(fta_sf(h, 1))
        h = fta_sf(fta_sf(h, 2), 3)
        h = fta_sf(_upsample22(h), 4)
        h = fta_sf(fta_sf(_upsample22(h), 5), 6)  # [B, 1, F, T]
        return torch.cat([at_least_f32(bm), at_least_f32(h)], dim=2)[:, 0]  # [B, F + 1, T]


class FTANet(nn.Module):
    def __init__(self, n_bins: int = 320, snippet_len: int = 128, dtype=F32):
        super().__init__()
        self.n_bins = n_bins
        self.snippet_len = snippet_len
        self.net = FTAUNet(n_bins, ((16, 4), (16, 4), (16, 4), (1, 5)), dtype=dtype)

    def forward(self, x, batch_stats: bool = False, dropout=None):
        # x: [B, T, 320, 3] (time, freq, ch) -> [B, 3, F, T]; no dropout
        # (`dropout` is taken for the models' common signature)
        if x.ndim != 4 or x.shape[2] != self.n_bins:
            raise ValueError(f"expected [B, T, {self.n_bins}, 3], got {tuple(x.shape)}")
        out = self.net(x.permute(0, 3, 2, 1), batch_stats)  # [B, 321, T]
        return out.transpose(1, 2)  # [B, T, 321]
