"""TONet (Ke Chen) — tone-octave network with dual FTAnet backbones, in
PyTorch (counterpart of viterbi_spl_tpu/models/tonet.py).

Architecture parity with the reference's retrained variant
tonet/model/tonet_shaun_simple.py:27-153 ("all" mode) +
tonet/model/ftanet.py:8-196 (the 360-bin torch FTAnet backbone) +
tonet/model/attention_layer.py:8-180 (pre-LN transformer encoder):

- two FTAnet-360 backbones: one on the CFP, one on the tone-shuffled TCFP
  (reshape/transpose trick, tonet/main_shaun.py:276-286),
- per-frame 720-dim aggregate feature -> tone & octave branches:
  Linear(720->2048) + sinusoid positional encoding + 2x CombineLayer
  (8-head pre-LN self-attention, d_k = d_v = 256, FFN 4096) -> MLP decoders
  to 12 tone / 6 octave classes (+ a non-melody logit from the bm rows),
- tcfp fusion conv (720->360 over time, k=5) and the final conv combining
  tone(13) + octave(7) + fused 360 + bm(1) = 381 -> 360 pitch logits,
  concat bm -> [B, 361, T].

Inputs follow the reference layout [B, 3, 360, T] (T = 128 snippets), which
is already NCHW with H = frequency, W = time. `model.train()` is the JAX
module's train=True: BatchNorm by the batch (its averages updated), and the
dropouts at the JAX module's sites and rates (attention probabilities 0.1;
the attention output, the FFN output, the branches' input and their MLP
decoders 0.2; mcdnn's 0.2) draw from the `dropout` generator, off without
one. `batch_stats=True` in eval mode normalizes by the batch's own
statistics and runs no dropout (the apps' eval_batch_stats forward).
Attention is a plain matmul + softmax, as the JAX module's einsum +
softmax. The ablation backbones (mcdnn, msnet, mldrnet) are
models/provenance.py's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tracing
from .ftanet import FTAModule, FTAUNet, SFModule
from .layers import F32, Conv, Dense, Dropout, LayerNorm, at_least_f32

# TONet's torch-variant SF and FTA modules (tonet/model/ftanet.py:8-123)
# compute what FTANet's do; only the flax param names differ
TorchSFModule = SFModule
TorchFTAModule = FTAModule

TONET_MODES = ("all", "spat", "spl", "tcfp", "single")
TONET_BACKBONES = ("ftanet", "mcdnn", "msnet", "mldrnet")


def cfp_to_tcfp(cfp: torch.Tensor) -> torch.Tensor:
    """Tone-shuffle: [B, 3, 360, T] -> octave-major to tone-major bin order
    (tonet/main_shaun.py:276-286)."""
    b, t = cfp.shape[0], cfp.shape[-1]
    return cfp.reshape(b, 3, 6, 60, t).transpose(2, 3).reshape(b, 3, 360, t)


class TorchFTAnet(FTAUNet):
    """360-bin torch FTAnet backbone (tonet/model/ftanet.py:126-196).
    Input [B, 3, F=360, T] -> logits [B, 361, T] (bm row first)."""

    def __init__(self, freq_bin: int = 360, dtype=F32):
        super().__init__(freq_bin, ((16, 4), (16, 3), (16, 6), (1, 5)), dtype=dtype)

    def forward(self, x, batch_stats: bool = False, dropout=None):
        return super().forward(x, batch_stats)


def _backbone(name: str, freq_bin: int, dtype) -> nn.Module:
    if name == "ftanet":
        return TorchFTAnet(freq_bin, dtype=dtype)
    from .provenance import MCDNN, MLDRnet, TonetMSNet

    return {"mcdnn": MCDNN, "msnet": TonetMSNet, "mldrnet": MLDRnet}[name](freq_bin, dtype=dtype)


@functools.lru_cache(maxsize=8)
def _position_table(n_position: int, d_hid: int) -> np.ndarray:
    """sinusoid_table, kept (not to be written): the model holds no buffer
    of its own, so that its whole state is its params and BatchNorm
    statistics."""
    return sinusoid_table(n_position, d_hid)


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


class CombineLayer(nn.Module):
    """Pre-LN transformer encoder layer (attention_layer.py:122-135):
    MHA (no-bias projections, residual) + position-wise FFN (residual)."""

    def __init__(self, d_model: int = 2048, d_inner: int = 4096, n_head: int = 8, dtype=F32):
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.d_k = d_model // n_head
        self.attn_ln = LayerNorm(d_model)
        self.w_qs = Dense(d_model, n_head * self.d_k, bias=False)
        self.w_ks = Dense(d_model, n_head * self.d_k, bias=False)
        self.w_vs = Dense(d_model, n_head * self.d_k, bias=False)
        self.fc = Dense(n_head * self.d_k, d_model, bias=False)
        self.ffn_ln = LayerNorm(d_model)
        self.w1 = Dense(d_model, d_inner)
        self.w2 = Dense(d_inner, d_model)
        self.attn_drop = Dropout(0.1)
        self.drop = Dropout(0.2)

    def forward(self, x, dropout=None):
        dt = self.dtype
        B, T, _ = x.shape
        h = self.attn_ln(x)

        def heads(proj):  # [B, H, T, d_k]
            return proj(h, dt).reshape(B, T, self.n_head, self.d_k).transpose(1, 2)

        q, k, v = heads(self.w_qs), heads(self.w_ks), heads(self.w_vs)
        # scores and softmax in float32; attn . v back in the compute dtype
        attn = at_least_f32(q @ k.transpose(-1, -2)) / np.float32(np.sqrt(self.d_k))
        attn = self.attn_drop(torch.softmax(attn, dim=-1), dropout).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(B, T, -1)
        x = at_least_f32(self.drop(self.fc(out, dt), dropout)) + x

        h = self.w2(F.relu(self.w1(self.ffn_ln(x), dt)), dt)
        return at_least_f32(self.drop(h, dropout)) + x


class _MLPDecoder(nn.Module):
    """Dense -> Dropout -> SELU stack (tonet_shaun_simple.py:96-115)."""

    def __init__(self, d_in: int, widths, dtype=F32):
        super().__init__()
        self.dtype = dtype
        dims = (d_in,) + tuple(widths)
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.drop = Dropout(0.2)

    def forward(self, x, dropout=None):
        for layer in self.layers:
            x = F.selu(self.drop(layer(x, self.dtype), dropout))
        return x


class _Branch(nn.Module):
    """The tone or octave branch: input projection (+ positional table, norm
    and two CombineLayers), or for "spl" the linear stand-in for the BiGRU,
    then the MLP decoder -> [B, n_cls, T] float32."""

    def __init__(self, d_in, attn_dim, seg_frame, widths, n_cls, spl: bool, dtype):
        super().__init__()
        self.spl, self.dtype = spl, dtype
        if spl:
            self.gru = Dense(d_in, 1024)
            width = 1024
        else:
            self.inp = Dense(d_in, attn_dim)
            self.norm = LayerNorm(attn_dim)
            self.attn = nn.ModuleList(CombineLayer(attn_dim, attn_dim * 2, dtype=dtype)
                                      for _ in range(2))
            self.seg_frame = seg_frame
            self.drop = Dropout(0.2)
            width = attn_dim
        self.linear = _MLPDecoder(width, tuple(widths) + (n_cls,), dtype=dtype)

    def forward(self, fa, dropout=None):
        if self.spl:
            h = self.gru(fa, self.dtype)
        else:
            h = at_least_f32(self.inp(fa, self.dtype))
            pos = _position_table(self.seg_frame, h.shape[-1])[: fa.shape[1]]
            h = h + tracing.upload(pos, h.device, "model")
            h = self.norm(self.drop(h, dropout))
            for layer in self.attn:
                h = layer(h, dropout)
        return at_least_f32(self.linear(h, dropout)).transpose(1, 2)


class TONet(nn.Module):
    """TONet with the original training module's ablation axes
    (tonet/model/tonet.py:24-265):

    mode — "all" (dual backbone + transformer tone/octave decoders, the
      retrained headline variant), "spat" (single backbone + transformer
      decoders), "spl" (single backbone + linear decoders), "tcfp" (dual
      backbone, direct 720->360 fusion, no tone/octave decoders), "single"
      (the bare backbone).
    backbone — "ftanet" | "mcdnn" | "msnet" | "mldrnet"
      (models/provenance.py), applied to both branches in the dual modes.

    The non-melody row comes FIRST in every output (class 0). Returns
    dict(pitch[, chroma, octave]); chroma/octave are None for the
    tcfp/single modes."""

    def __init__(self, freq_bin: int = 360, tone_class: int = 12, octave_class: int = 6,
                 attn_dim: int = 2048, seg_frame: int = 128, mode: str = "all",
                 backbone: str = "ftanet", dtype=F32):
        super().__init__()
        if mode not in TONET_MODES:
            raise ValueError(f"unknown TONet mode {mode!r}")
        if backbone not in TONET_BACKBONES:
            raise ValueError(f"unknown TONet backbone {backbone!r}")
        self.freq_bin, self.mode, self.backbone, self.dtype = freq_bin, mode, backbone, dtype
        self.dual = mode in ("all", "tcfp")
        self.l_model = _backbone(backbone, freq_bin, dtype)
        if self.dual:
            self.r_model = _backbone(backbone, freq_bin, dtype)
        if mode == "tcfp":
            self.final_linear_tcfp = Dense(2 * freq_bin, freq_bin)
            self.final_bm = Dense(2, 1)
        elif mode != "single":
            d_in = 2 * freq_bin if self.dual else freq_bin
            spl = mode == "spl"
            self.tone = _Branch(d_in, attn_dim, seg_frame, (512, 128), tone_class, spl, dtype)
            self.octave = _Branch(d_in, attn_dim, seg_frame, (256, 64), octave_class, spl, dtype)
            if self.dual:
                self.tcfp_linear = Conv(2 * freq_bin, freq_bin, (5,))
                self.tcfp_bm = Conv(2, 1, (5,))
                self.tone_bm = Dense(2, 1)
                self.octave_bm = Dense(2, 1)
            n_final = tone_class + 1 + octave_class + 1 + freq_bin + 1
            self.final_linear = Conv(n_final, freq_bin, (5,))

    def forward(self, cfp, tcfp=None, batch_stats: bool = False, dropout=None):
        if cfp.ndim != 4 or cfp.shape[1] != 3 or cfp.shape[2] != self.freq_bin:
            raise ValueError(f"expected [B, 3, {self.freq_bin}, T], got {tuple(cfp.shape)}")
        dt = self.dtype
        out_l = self.l_model(cfp, batch_stats, dropout)
        if self.mode == "single":
            return dict(pitch=out_l, chroma=None, octave=None)

        bm_l, feat_l = out_l[:, :1], out_l[:, 1:]
        if self.dual:
            out_r = self.r_model(cfp_to_tcfp(cfp) if tcfp is None else tcfp, batch_stats, dropout)
            feature_agg = torch.cat([feat_l, out_r[:, 1:]], dim=1)  # [B, 720, T]
            bm_agg = torch.cat([bm_l, out_r[:, :1]], dim=1)  # [B, 2, T]
        else:
            feature_agg, bm_agg = feat_l, bm_l

        fa = feature_agg.transpose(1, 2)  # [B, T, 720] / 360
        ba = bm_agg.transpose(1, 2)  # [B, T, 2] / 1
        if self.mode == "tcfp":
            # direct fusion (tonet/model/tonet.py:139-151, 219-235)
            fin = at_least_f32(F.selu(self.final_linear_tcfp(fa, dt)))
            fbm = at_least_f32(F.selu(self.final_bm(ba, dt)))
            pitch = torch.cat([fbm.transpose(1, 2), fin.transpose(1, 2)], dim=1)
            return dict(pitch=pitch, chroma=None, octave=None)

        if self.dual:
            # "all": the tcfp fusion convs over time (channels = freq bins)
            feature_agg_mi = at_least_f32(F.selu(self.tcfp_linear(feature_agg, dt)))  # [B, 360, T]
            bm_agg_mi = at_least_f32(F.selu(self.tcfp_bm(bm_agg, dt)))  # [B, 1, T]
        else:
            feature_agg_mi, bm_agg_mi = feature_agg, bm_agg

        tone_prob = self.tone(fa, dropout)  # [B, 12, T]
        octave_prob = self.octave(fa, dropout)  # [B, 6, T]
        if self.dual:
            tone_bm = at_least_f32(F.selu(self.tone_bm(ba, dt)))  # [B, T, 1]
            octave_bm = at_least_f32(F.selu(self.octave_bm(ba, dt)))
        else:
            tone_bm = octave_bm = at_least_f32(ba)
        tone_prob = torch.cat([tone_bm.transpose(1, 2), tone_prob], dim=1)  # [B, 13, T]
        octave_prob = torch.cat([octave_bm.transpose(1, 2), octave_prob], dim=1)  # [B, 7, T]

        final = torch.cat([tone_prob, octave_prob, feature_agg_mi, bm_agg_mi], dim=1)
        final = at_least_f32(F.selu(self.final_linear(final, dt)))  # [B, 360, T]
        pitch = torch.cat([bm_agg_mi, final], dim=1)  # [B, 361, T]
        return dict(pitch=pitch, chroma=tone_prob, octave=octave_prob)
