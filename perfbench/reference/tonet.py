"""TONet (Chen et al., ICASSP 2022) in plain PyTorch, float32: mode "all"
with two 360-bin FTANet backbones (github.com/RetroCirce/TONet,
tonet/model/tonet.py, ftanet.py, attention_layer.py).

A frozen copy with the parameter names of the measured program's module
tree, so that one set of benchmark-made weights loads into both. Inference
only, so no dropout. BatchNorm follows flax's numerics (epsilon 1e-5,
biased two-pass variance); `batch_stats=True` normalizes by the batch, as
the program's eval_batch_stats does, without touching the averages. Layout [B, 3, 360, T] in,
dict(pitch [B, 361, T], chroma [B, 13, T], octave [B, 7, T]) out, the
non-melody row first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

class BatchNorm(nn.Module):
    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x, batch_stats: bool = False):
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        if batch_stats:
            axes = [d for d in range(x.ndim) if d != 1]
            mu = x.mean(dim=axes)
            var = ((x - mu.view(shape)) ** 2).mean(dim=axes)
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)


class LayerNorm(nn.Module):
    def __init__(self, n: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class Conv(nn.Module):
    """1-D or 2-D convolution; "same" pads as XLA does, "valid" not at all."""

    def __init__(self, c_in, c_out, kernel, stride=1, padding="same"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self._conv = F.conv1d if len(kernel) == 1 else F.conv2d

    def forward(self, x):
        return self._conv(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    def __init__(self, d_in, d_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class SFModule(nn.Module):
    """Selective-kernel fusion: mean pool, BatchNorm, Dense + SELU, one mask
    per branch, softmax over the channel axis."""

    def __init__(self, n_channel, n_branches=3, reduction=4, limitation=4):
        super().__init__()
        hidden = max(n_channel // reduction, limitation)
        self.bn = BatchNorm(n_channel)
        self.fuse = Dense(n_channel, hidden)
        self.masks = nn.ModuleList(Dense(hidden, n_channel) for _ in range(n_branches))

    def forward(self, x_list, batch_stats=False):
        fused = sum(x_list).mean(dim=(2, 3))
        fused = F.selu(self.fuse(self.bn(fused, batch_stats)))
        mask = torch.softmax(torch.stack([m(fused) for m in self.masks], dim=-1), dim=-2)
        out = 0.0
        for i, x_s in enumerate(x_list):
            out = out + x_s * mask[:, :, i, None, None]
        return out


class FTAModule(nn.Module):
    """Residual, time-attention and frequency-attention branches."""

    def __init__(self, c_in, c, kt=3, kf=3):
        super().__init__()
        self.bn = BatchNorm(c_in)
        self.res = Conv(c_in, c, (1, 1))
        self.ta1, self.ta2 = Conv(c_in, c, (kt,)), Conv(c, c, (kt,))
        self.t3, self.t5 = Conv(c_in, c, (3, 3)), Conv(c, c, (5, 5))
        self.fa1, self.fa2 = Conv(c_in, c, (kf,)), Conv(c, c, (kf,))
        self.f3, self.f5 = Conv(c_in, c, (3, 3)), Conv(c, c, (5, 5))

    def forward(self, x, batch_stats=False):
        x = self.bn(x, batch_stats)
        x_r = F.relu(self.res(x))
        a_t = torch.softmax(F.selu(self.ta2(F.selu(self.ta1(x.mean(dim=2))))), dim=-1)
        x_t = F.selu(self.t5(F.selu(self.t3(x)))) * a_t[:, :, None, :]
        a_f = torch.softmax(F.selu(self.fa2(F.selu(self.fa1(x.mean(dim=3))))), dim=-1)
        x_f = F.selu(self.f5(F.selu(self.f3(x)))) * a_f[:, :, :, None]
        return x_r, x_t, x_f


class FTAnet(nn.Module):
    """The 360-bin FTANet backbone: [B, 3, 360, T] -> [B, 361, T]."""

    def __init__(self, freq_bin=360):
        super().__init__()
        self.in_bn = BatchNorm(3)
        c_in, bm = 3, []
        for ch, k in ((16, 4), (16, 3), (16, 6), (1, 5)):
            bm.append(Conv(c_in, ch, (k, 1), stride=(k, 1), padding="valid"))
            c_in = ch
        self.bm = nn.ModuleList(bm)
        chans = (32, 64, 128, 128, 64, 32, 1)
        ins = (3,) + chans[:-1]
        self.fta = nn.ModuleList(FTAModule(i, c) for i, c in zip(ins, chans))
        self.sf = nn.ModuleList(SFModule(c) for c in chans)

    def forward(self, x, batch_stats=False):
        x = self.in_bn(x, batch_stats)
        bm = x
        for conv in self.bm:
            bm = F.selu(conv(bm))

        def fta_sf(h, i):
            return self.sf[i](self.fta[i](h, batch_stats), batch_stats)

        def up(h):
            return h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        h = F.max_pool2d(fta_sf(x, 0), 2, 2)
        h = F.max_pool2d(fta_sf(h, 1), 2, 2)
        h = fta_sf(fta_sf(h, 2), 3)
        h = fta_sf(up(h), 4)
        h = fta_sf(fta_sf(up(h), 5), 6)
        return torch.cat([bm, h], dim=2)[:, 0]


def sinusoid_table(n_position, d_hid):
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


class CombineLayer(nn.Module):
    """Pre-LN encoder layer: 8-head self-attention (no-bias projections)
    and a position-wise FFN, each with a residual."""

    def __init__(self, d_model, d_inner, n_head=8):
        super().__init__()
        self.n_head, self.d_k = n_head, d_model // n_head
        self.attn_ln = LayerNorm(d_model)
        self.w_qs = Dense(d_model, d_model, bias=False)
        self.w_ks = Dense(d_model, d_model, bias=False)
        self.w_vs = Dense(d_model, d_model, bias=False)
        self.fc = Dense(d_model, d_model, bias=False)
        self.ffn_ln = LayerNorm(d_model)
        self.w1 = Dense(d_model, d_inner)
        self.w2 = Dense(d_inner, d_model)

    def forward(self, x):
        B, T, _ = x.shape
        h = self.attn_ln(x)

        def heads(proj):
            return proj(h).reshape(B, T, self.n_head, self.d_k).transpose(1, 2)

        q, k, v = heads(self.w_qs), heads(self.w_ks), heads(self.w_vs)
        attn = (q @ k.transpose(-1, -2)) / np.float32(np.sqrt(self.d_k))
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, T, -1)
        x = self.fc(out) + x
        return self.w2(F.relu(self.w1(self.ffn_ln(x)))) + x


class MLPDecoder(nn.Module):
    def __init__(self, d_in, widths):
        super().__init__()
        dims = (d_in,) + tuple(widths)
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = F.selu(layer(x))
        return x


class Branch(nn.Module):
    """Tone or octave branch: projection + positions, two encoder layers,
    then the MLP decoder -> [B, n_cls, T]."""

    def __init__(self, d_in, attn_dim, seg_frame, widths, n_cls):
        super().__init__()
        self.inp = Dense(d_in, attn_dim)
        self.norm = LayerNorm(attn_dim)
        self.attn = nn.ModuleList(CombineLayer(attn_dim, attn_dim * 2) for _ in range(2))
        self.seg_frame = seg_frame
        self.linear = MLPDecoder(attn_dim, tuple(widths) + (n_cls,))

    def forward(self, fa):
        h = self.inp(fa)
        pos = sinusoid_table(self.seg_frame, h.shape[-1])[: fa.shape[1]]
        h = self.norm(h + torch.as_tensor(pos, device=h.device))
        for layer in self.attn:
            h = layer(h)
        return self.linear(h).transpose(1, 2)


class TONet(nn.Module):
    def __init__(self, freq_bin=360, tone_class=12, octave_class=6, attn_dim=2048, seg_frame=128):
        super().__init__()
        self.freq_bin = freq_bin
        self.l_model = FTAnet(freq_bin)
        self.r_model = FTAnet(freq_bin)
        d_in = 2 * freq_bin
        self.tone = Branch(d_in, attn_dim, seg_frame, (512, 128), tone_class)
        self.octave = Branch(d_in, attn_dim, seg_frame, (256, 64), octave_class)
        self.tcfp_linear = Conv(2 * freq_bin, freq_bin, (5,))
        self.tcfp_bm = Conv(2, 1, (5,))
        self.tone_bm = Dense(2, 1)
        self.octave_bm = Dense(2, 1)
        self.final_linear = Conv(tone_class + octave_class + 2 + freq_bin + 1, freq_bin, (5,))

    def forward(self, cfp, batch_stats=False):
        b, t = cfp.shape[0], cfp.shape[-1]
        tcfp = cfp.reshape(b, 3, 6, 60, t).transpose(2, 3).reshape(b, 3, 360, t)
        out_l = self.l_model(cfp, batch_stats)
        out_r = self.r_model(tcfp, batch_stats)
        feature_agg = torch.cat([out_l[:, 1:], out_r[:, 1:]], dim=1)
        bm_agg = torch.cat([out_l[:, :1], out_r[:, :1]], dim=1)
        fa, ba = feature_agg.transpose(1, 2), bm_agg.transpose(1, 2)
        feature_agg_mi = F.selu(self.tcfp_linear(feature_agg))
        bm_agg_mi = F.selu(self.tcfp_bm(bm_agg))
        tone = self.tone(fa)
        octave = self.octave(fa)
        tone = torch.cat([F.selu(self.tone_bm(ba)).transpose(1, 2), tone], dim=1)
        octave = torch.cat([F.selu(self.octave_bm(ba)).transpose(1, 2), octave], dim=1)
        final = torch.cat([tone, octave, feature_agg_mi, bm_agg_mi], dim=1)
        final = F.selu(self.final_linear(final))
        return dict(pitch=torch.cat([bm_agg_mi, final], dim=1), chroma=tone, octave=octave)


def pitch_logits(out) -> torch.Tensor:
    """[B, 361, T] -> [B, T, 360] logits re-referenced to the non-melody row."""
    pitch = out["pitch"].transpose(1, 2)
    return pitch[..., 1:] - pitch[..., :1]


def note_range() -> np.ndarray:
    """MIDI notes of TONet's 360 bins: the CFP's central frequencies
    (32 Hz, 60 bins an octave) from the second on."""
    from .cfp import CFPConfig

    c = CFPConfig(sr=8000, win_len=768, hop_size=80, fmin=32, fmax=2050).central_freqs[1:]
    return (69.0 + 12.0 * np.log2(c / 440.0)).astype(np.float32)


def tonet_loss(notes: torch.Tensor, out: dict) -> torch.Tensor:
    """Mean of the pitch, chroma and octave cross-entropies on integer
    labels (tonet/main_shaun.py): pitch = the first grid note >= the note
    (0 unvoiced), octave = (pitch - 1) // 60 + 1, chroma = (pitch - 1) % 60
    // 5 + 1."""
    grid = torch.as_tensor(note_range(), device=notes.device)
    positive = notes > 0.0
    n = torch.where(positive & (notes < grid[0]), grid[0], notes)
    n = torch.where(n > grid[-1], grid[-1], n)
    full = torch.cat([torch.zeros(1, device=grid.device), grid])
    pitch = torch.argmax(((full[None, None, :] - n[..., None]) >= 0.0).to(torch.uint8), dim=-1)
    octave = torch.where(positive, torch.div(pitch - 1, 60, rounding_mode="floor") + 1, 0)
    chroma = torch.where(positive, torch.div((pitch - 1) % 60, 5, rounding_mode="floor") + 1, 0)

    def ce(lg, lb):
        lg = lg.transpose(1, 2)
        return -torch.gather(F.log_softmax(lg, dim=-1), -1, lb[..., None].long())[..., 0]

    losses = [ce(out["pitch"], pitch), ce(out["chroma"], chroma), ce(out["octave"], octave)]
    return torch.mean(torch.stack(losses, dim=-1))
