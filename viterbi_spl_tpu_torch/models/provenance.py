"""Provenance backbones in PyTorch (counterpart of
viterbi_spl_tpu/models/provenance.py): MCDNN, the 360-bin MSnet variant and
MLDRnet, TONet's alternative torch backbones kept by the reference for
provenance (tonet/model/mcdnn.py:5-44, tonet/model/msnet.py:6-72,
tonet/model/multi_dr.py:5-187). The retrained TONet uses the FTAnet
backbone; these serve its `backbone=` ablations.

Each takes TONet's input [B, 3, 360, T] (NCHW with H = frequency, W = time,
the JAX modules' NHWC [B, F, T, C] with the channel axis moved) and returns
pitch logits [B, 361, T], the non-melody row first, as TorchFTAnet does.
`model.train()` is the JAX modules' train=True; MCDNN's dropouts (0.2) draw
from the `dropout` generator, off without one. Layer names follow the
flax modules' (models/convert.py carries their weights across).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import F32, BatchNorm, Conv, Dense, Dropout, at_least_f32


class MCDNN(nn.Module):
    """Per-frame MLP over the flattened 3 x 360 CFP column."""

    def __init__(self, freq_bin: int = 360, dtype=F32):
        super().__init__()
        self.dtype = dtype

        def mlp(widths):
            dims = (3 * freq_bin,) + widths
            return nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

        self.mcdnn = mlp((2048, 1024, 512, freq_bin))
        self.bm = mlp((512, 128, 1))
        self.drop = Dropout(0.2)

    def forward(self, x, batch_stats: bool = False, dropout=None):
        B, C, Fr, T = x.shape
        h = x.reshape(B, C * Fr, T).transpose(1, 2)  # [B, T, 3 F]

        def mlp(h, layers, last_selu):
            for i, layer in enumerate(layers):
                h = layer(h, self.dtype)
                if i < len(layers) - 1:
                    h = F.selu(self.drop(h, dropout))
                elif last_selu:
                    h = F.selu(h)
            return at_least_f32(h)

        out = torch.cat([mlp(h, self.bm, True), mlp(h, self.mcdnn, False)], dim=-1)
        return out.transpose(1, 2)  # [B, 361, T]


def pool_freq_argmax(x, g: int):
    """[B, C, F, T] -> ([B, C, F // g, T] max over frequency groups of g,
    the in-group argmax, the first maximum) — MaxPool2d((g, 1),
    return_indices=True) semantics."""
    B, C, Fr, T = x.shape
    grp = x.reshape(B, C, Fr // g, g, T)
    return grp.amax(dim=3), grp.argmax(dim=3)


def unpool_freq(x, idx, g: int):
    """Inverse of pool_freq_argmax: each value back to its argmax slot."""
    B, C, Fp, T = x.shape
    onehot = F.one_hot(idx, g).to(x.dtype).movedim(-1, 3)  # [B, C, Fp, g, T]
    return (x[:, :, :, None] * onehot).reshape(B, C, Fp * g, T)


class TonetMSNet(nn.Module):
    """The 360-bin MSnet backbone variant TONet ablates against
    (tonet/model/msnet.py:6-72): frequency pools 4/3/6 with argmax
    unpooling, a 5-bin VALID "bottom" conv producing the non-melody row.
    [B, 3, 360, T] -> pre-softmax logits [B, 361, T]."""

    POOLS = (4, 3, 6)

    def __init__(self, freq_bin: int = 360, dtype=F32):
        super().__init__()
        self.dtype = dtype
        chans = (3, 32, 64, 128)
        self.enc_bn = nn.ModuleList(BatchNorm(c) for c in chans[:3])
        self.enc_conv = nn.ModuleList(Conv(a, b, (5, 5)) for a, b in zip(chans[:3], chans[1:]))
        self.bm_bn = BatchNorm(128)
        self.bm_conv = Conv(128, 1, (5, 5), padding="valid")
        # decoder layer i: dec_bn[i] and dec_conv[i] (run 2, 1, 0)
        dec = ((32, 1), (64, 32), (128, 64))
        self.dec_bn = nn.ModuleList(BatchNorm(a) for a, _ in dec)
        self.dec_conv = nn.ModuleList(Conv(a, b, (5, 5)) for a, b in dec)

    def forward(self, x, batch_stats: bool = False, dropout=None):
        dt = self.dtype
        h, inds = x, []
        for bn, conv, g in zip(self.enc_bn, self.enc_conv, self.POOLS):
            h, idx = pool_freq_argmax(F.selu(conv(bn(h, batch_stats), dt)), g)
            inds.append(idx)
        # h: [B, 128, 5, T]; the bottom conv is VALID over frequency, SAME
        # (a pad of 2) over time
        bm = self.bm_bn(h, batch_stats)
        bm = F.selu(self.bm_conv(F.pad(bm, (2, 2)), dt))  # [B, 1, 1, T]
        for i in (2, 1, 0):
            h = unpool_freq(h, inds[i], self.POOLS[i])
            h = F.selu(self.dec_conv[i](self.dec_bn[i](h, batch_stats), dt))
        return torch.cat([at_least_f32(bm), at_least_f32(h)], dim=2)[:, 0]  # [B, 361, T]


class ConvTranspose2x(Conv):
    """flax ConvTranspose with a 1 x 1 kernel, stride 2 and SAME padding:
    each value lands on the even rows and columns of a map twice the size,
    the bias everywhere."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, (1, 1))

    def forward(self, x, dtype=F32):
        return F.conv_transpose2d(x.to(dtype), self.weight.transpose(0, 1).to(dtype),
                                  self.bias.to(dtype), stride=2, output_padding=1)


class _MultiDilation(nn.Module):
    """Densely-connected dilated conv block (multi_dr.py:161-181)."""

    def __init__(self, c_in: int, out_ch: int = 10, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.bn1, self.bn2, self.bn3 = (BatchNorm(c_in + k * out_ch) for k in range(3))
        self.c1 = Conv(c_in, out_ch, (3, 3), dilation=3)
        self.c2 = Conv(c_in + out_ch, out_ch, (3, 3), dilation=6)
        self.c3 = Conv(c_in + 2 * out_ch, out_ch, (3, 3), dilation=6)

    def forward(self, x, batch_stats: bool = False):
        dt = self.dtype
        x1 = at_least_f32(F.selu(self.c1(self.bn1(x, batch_stats), dt)))
        x2 = torch.cat([x, x1], dim=1)
        x2 = at_least_f32(F.selu(self.c2(self.bn2(x2, batch_stats), dt)))
        x3 = torch.cat([x, x1, x2], dim=1)
        return at_least_f32(F.selu(self.c3(self.bn3(x3, batch_stats), dt)))


class MLDRnet(nn.Module):
    """Multi-dilation pyramid network (tonet/model/multi_dr.py:5-187)."""

    def __init__(self, freq_bin: int = 360, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.enc_bn = BatchNorm(3)
        self.c2_1 = Conv(3, 3, (3, 3), stride=2)
        self.c3_1 = Conv(3, 3, (3, 3), stride=2)
        for i in range(3):
            setattr(self, f"md_{i}", _MultiDilation(3, dtype=dtype))
        self.c1_1 = Conv(10, 10, (3, 3), stride=2)
        self.c1_2 = Conv(10, 10, (3, 3), stride=2)
        self.c2_2 = ConvTranspose2x(10, 10)
        self.c2_3 = Conv(10, 10, (3, 3), stride=2)
        self.c3_2 = ConvTranspose2x(10, 10)
        self.c3_3 = ConvTranspose2x(10, 10)
        for i in range(3, 6):
            setattr(self, f"md_{i}", _MultiDilation(30, dtype=dtype))
        self.c2_4 = ConvTranspose2x(10, 10)
        self.c3_4 = ConvTranspose2x(10, 10)
        self.c3_5 = ConvTranspose2x(10, 10)
        self.enc_final = Conv(30, 10, (1, 1))
        self.dec_bn = BatchNorm(10)
        self.dec_c1 = Conv(10, 10, (3, 3))
        self.bm_bn = BatchNorm(10)
        self.bm_conv = Conv(10, 1, (3, 3))
        self.fin_bn = BatchNorm(10)
        self.fin_c1 = Conv(10, 10, (3, 3))
        self.fin_c2 = Conv(10, 1, (3, 3))

    def forward(self, x, batch_stats: bool = False, dropout=None):
        dt, bs = self.dtype, batch_stats
        f1 = self.enc_bn(x, bs)  # [B, 3, F, T]
        f2 = self.c2_1(f1, dt)
        f3 = self.c3_1(f2, dt)
        f1, f2, f3 = self.md_0(f1, bs), self.md_1(f2, bs), self.md_2(f3, bs)

        f1_2 = self.c1_1(f1, dt)
        f1_3 = self.c1_2(f1_2, dt)
        f2_1 = self.c2_2(f2, dt)
        f2_3 = self.c2_3(f2, dt)
        f3_2 = self.c3_2(f3, dt)
        f3_1 = self.c3_3(f3_2, dt)

        f1 = self.md_3(torch.cat([f1, f2_1, f3_1], dim=1), bs)
        f2 = self.md_4(torch.cat([f2, f1_2, f3_2], dim=1), bs)
        f3 = self.md_5(torch.cat([f3, f1_3, f2_3], dim=1), bs)

        f2 = self.c2_4(f2, dt)
        f3 = self.c3_5(self.c3_4(f3, dt), dt)
        enc = self.enc_final(torch.cat([f1, f2, f3], dim=1), dt)

        d = F.selu(self.dec_c1(self.dec_bn(enc, bs), dt))
        bm = d.mean(dim=2, keepdim=True)  # average over frequency
        bm = F.selu(self.bm_conv(self.bm_bn(bm, bs), dt))
        fin = F.selu(self.fin_c1(self.fin_bn(d, bs), dt))
        fin = F.selu(self.fin_c2(fin, dt))
        return torch.cat([at_least_f32(bm), at_least_f32(fin)], dim=2)[:, 0]  # [B, 361, T]
