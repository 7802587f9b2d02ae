"""Weights carried across: the JAX package's flax params and batch stats of a
model family -> this port's state_dict, and the model's constructor
arguments where the params fix them.

One function per family (`tonet_state_dict` with each of TONet's backbones,
ftanet's or one of models/provenance.py's, `ftanet_state_dict`,
`msnet_state_dict`, `jdc_state_dict`, `dcnet_state_dict`), each a NumPy
tree in (nested dicts of arrays, as flax's `variables["params"]` and
`variables["batch_stats"]` hold them) and a state_dict of float32 tensors out; `convert(family, ...)`
picks one. Layouts: conv kernels HWIO (2-D) or WIO (1-D) -> OIHW / OIW,
dense kernels [in, out] -> [out, in]; BatchNorm's scale, bias, mean and var
and LayerNorm's scale and bias carry over as they are; an
OptimizedLSTMCell's eight kernels -> nn.LSTM's stacked (i, f, g, o)
weights, the hidden kernels' bias in bias_hh and bias_ih zero. A gradient
or an Adam moment tree has the params' names and shapes, and converts as
the params do (scripts/orbax_to_torch.py carries optax's Adam state so).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


class _Out:
    """state_dict under construction."""

    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def conv(self, name, p):
        k = np.asarray(p["kernel"])
        perm = (2, 1, 0) if k.ndim == 3 else (3, 2, 0, 1)
        self.sd[f"{name}.weight"] = _t(k.transpose(perm))
        if "bias" in p:
            self.sd[f"{name}.bias"] = _t(p["bias"])

    def dense(self, name, p):
        self.sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.sd[f"{name}.bias"] = _t(p["bias"])

    def norm(self, name, p, stats=None):
        for key in ("scale", "bias"):
            if p is not None and key in p:
                self.sd[f"{name}.{key}"] = _t(p[key])
        if stats is not None:
            self.sd[f"{name}.mean"] = _t(stats["mean"])
            self.sd[f"{name}.var"] = _t(stats["var"])

    def lstm(self, name, p):
        for suffix, cell in (("", p["OptimizedLSTMCell_0"]), ("_reverse", p["OptimizedLSTMCell_1"])):
            w_ih = np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("ii", "if", "ig", "io")])
            w_hh = np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("hi", "hf", "hg", "ho")])
            b_hh = np.concatenate([np.asarray(cell[g]["bias"]) for g in ("hi", "hf", "hg", "ho")])
            self.sd[f"{name}.lstm.weight_ih_l0{suffix}"] = _t(w_ih)
            self.sd[f"{name}.lstm.weight_hh_l0{suffix}"] = _t(w_hh)
            self.sd[f"{name}.lstm.bias_ih_l0{suffix}"] = torch.zeros(w_ih.shape[0])
            self.sd[f"{name}.lstm.bias_hh_l0{suffix}"] = _t(b_hh)


# the U-net's flax names: FTANet's, and TONet's torch-variant backbone's
_FTANET_NAMES = dict(bm="bm_conv_{}", fta="fta{}", sf="sf{}", fuse="fuse_dense",
                     mask="mask_dense_{}", res="res_conv", ta1="ta_conv1", ta2="ta_conv2",
                     t3="t_conv3", t5="t_conv5", fa1="fa_conv1", fa2="fa_conv2",
                     f3="f_conv3", f5="f_conv5", first=0)
_TORCH_FTA_NAMES = dict(bm="bm_{}", fta="fta_{}", sf="sf_{}", fuse="fuse", mask="mask_{}",
                        res="res", ta1="ta1", ta2="ta2", t3="ta3", t5="ta4", fa1="fa1",
                        fa2="fa2", f3="fa3", f5="fa4", first=1)


def _unet(out: _Out, prefix: str, p, s, names) -> None:
    out.norm(f"{prefix}in_bn", p["in_bn"], s["in_bn"])
    for i in range(4):
        out.conv(f"{prefix}bm.{i}", p[names["bm"].format(i)])
    for i in range(7):
        fp = p[names["fta"].format(i + names["first"])]
        fs = s[names["fta"].format(i + names["first"])]
        pre = f"{prefix}fta.{i}"
        out.norm(f"{pre}.bn", fp["bn"], fs["bn"])
        for port in ("res", "ta1", "ta2", "t3", "t5", "fa1", "fa2", "f3", "f5"):
            out.conv(f"{pre}.{port}", fp[names[port]])
        sp = p[names["sf"].format(i + names["first"])]
        ss = s[names["sf"].format(i + names["first"])]
        pre = f"{prefix}sf.{i}"
        out.norm(f"{pre}.bn", sp["bn"], ss["bn"])
        out.dense(f"{pre}.fuse", sp[names["fuse"]])
        for j in range(3):
            out.dense(f"{pre}.masks.{j}", sp[names["mask"].format(j)])


def _mcdnn(out: _Out, prefix: str, p, s) -> None:
    for i in range(4):
        out.dense(f"{prefix}mcdnn.{i}", p[f"mcdnn_{i}"])
    for i in range(3):
        out.dense(f"{prefix}bm.{i}", p[f"bm_{i}"])


def _tonet_msnet(out: _Out, prefix: str, p, s) -> None:
    for part in ("enc", "dec"):
        for i in range(3):
            out.norm(f"{prefix}{part}_bn.{i}", p[f"{part}_{i}_bn"], s[f"{part}_{i}_bn"])
            out.conv(f"{prefix}{part}_conv.{i}", p[f"{part}_{i}_conv"])
    out.norm(f"{prefix}bm_bn", p["bm_bn"], s["bm_bn"])
    out.conv(f"{prefix}bm_conv", p["bm_conv"])


def _mldrnet(out: _Out, prefix: str, p, s) -> None:
    for name, sub in p.items():
        if name.startswith("md_"):
            for j in (1, 2, 3):
                out.norm(f"{prefix}{name}.bn{j}", sub[f"bn{j}"], s[name][f"bn{j}"])
                out.conv(f"{prefix}{name}.c{j}", sub[f"c{j}"])
        elif name.endswith("_bn"):
            out.norm(f"{prefix}{name}", sub, s[name])
        else:  # a conv, or a 1 x 1 transposed conv (the same HWIO layout)
            out.conv(f"{prefix}{name}", sub)


def tonet_backbone(params) -> str:
    """Which backbone a TONet param tree holds (its l_model's layer names)."""
    names = params["l_model"]
    if "mcdnn_0" in names:
        return "mcdnn"
    if "enc_0_bn" in names:
        return "msnet"
    if "md_0" in names:
        return "mldrnet"
    return "ftanet"


_BACKBONES = {"mcdnn": _mcdnn, "msnet": _tonet_msnet, "mldrnet": _mldrnet}


def ftanet_state_dict(params, batch_stats) -> dict:
    out = _Out()
    _unet(out, "net.", params, batch_stats, _FTANET_NAMES)
    return out.sd


def tonet_kwargs(params) -> dict:
    """TONet's constructor arguments that its params fix: the mode (which
    sub-modules exist), the backbone, and attn_dim (the width of the
    branches' input projection)."""
    if "r_model" in params:
        mode = "tcfp" if "final_linear_tcfp" in params else "all"
    elif "tone_gru" in params:
        mode = "spl"
    elif "tone_in" in params:
        mode = "spat"
    else:
        mode = "single"
    kw = dict(mode=mode)
    if tonet_backbone(params) != "ftanet":
        kw["backbone"] = tonet_backbone(params)
    if "tone_in" in params:
        kw["attn_dim"] = int(np.asarray(params["tone_in"]["kernel"]).shape[1])
    return kw


def tonet_state_dict(params, batch_stats) -> dict:
    out = _Out()
    backbone = tonet_backbone(params)
    for side in ("l_model", "r_model"):
        if side in params:
            if backbone == "ftanet":
                _unet(out, f"{side}.", params[side], batch_stats[side], _TORCH_FTA_NAMES)
            else:
                _BACKBONES[backbone](out, f"{side}.", params[side], batch_stats.get(side, {}))
    for name in ("tcfp_linear", "tcfp_bm", "final_linear"):
        if name in params:
            out.conv(name, params[name])
    for name in ("tone_bm", "octave_bm", "final_linear_tcfp", "final_bm"):
        if name in params:
            out.dense(name, params[name])
    for branch in ("tone", "octave"):
        if f"{branch}_gru" in params:
            out.dense(f"{branch}.gru", params[f"{branch}_gru"])
        if f"{branch}_in" in params:
            out.dense(f"{branch}.inp", params[f"{branch}_in"])
            out.norm(f"{branch}.norm", params[f"{branch}_norm"])
            for i in range(2):
                a = params[f"{branch}_attn_{i}"]
                pre = f"{branch}.attn.{i}"
                for name in ("w_qs", "w_ks", "w_vs", "fc", "w1", "w2"):
                    out.dense(f"{pre}.{name}", a[name])
                out.norm(f"{pre}.attn_ln", a["attn_ln"])
                out.norm(f"{pre}.ffn_ln", a["ffn_ln"])
        if f"{branch}_linear" in params:
            lin = params[f"{branch}_linear"]
            for j in range(len(lin)):
                out.dense(f"{branch}.linear.layers.{j}", lin[f"dense_{j}"])
    return out.sd


def msnet_state_dict(params, batch_stats) -> dict:
    out = _Out()
    for i in range(3):
        out.norm(f"enc_bn.{i}", params.get(f"enc_bn_{i}"), batch_stats[f"enc_bn_{i}"])
        out.conv(f"enc_conv.{i}", params[f"enc_conv_{i}"])
        out.norm(f"dec_bn.{i}", params.get(f"dec_bn_{i}"), batch_stats[f"dec_bn_{i}"])
        out.conv(f"dec_conv.{i}", params[f"dec_conv_{i}"])
    out.norm("nm_bn", params["nm_bn"], batch_stats["nm_bn"])
    out.conv("nm_conv", params["nm_conv"])
    return out.sd


def jdc_state_dict(params, batch_stats) -> dict:
    out = _Out()
    out.conv("conv1_1", params["conv1_1"])
    out.conv("conv1_2", params["conv1_2"])
    out.norm("bn1", params["bn1"], batch_stats["bn1"])
    for b in ("block2", "block3", "block4"):
        for name in ("conv_1x1", "conv_1", "conv_2"):
            out.conv(f"{b}.{name}", params[b][name])
        for name in ("pre_bn", "mid_bn"):
            out.norm(f"{b}.{name}", params[b][name], batch_stats[b][name])
    out.norm("bn4", params["bn4"], batch_stats["bn4"])
    out.norm("v_bn", params["v_bn"], batch_stats["v_bn"])
    out.conv("v_conv", params["v_conv"])
    out.lstm("pitch_lstm", params["pitch_lstm"])
    out.lstm("v_lstm", params["v_lstm"])
    out.dense("pitch_dense", params["pitch_dense"])
    out.dense("v_dense", params["v_dense"])
    return out.sd


def dcnet_state_dict(params, batch_stats) -> dict:
    out = _Out()
    for i in range(4):
        out.conv(f"local_conv.{i}", params[f"local_conv_{i}"])
        out.norm(f"local_bn.{i}", params[f"local_bn_{i}"], batch_stats[f"local_bn_{i}"])
    out.conv("global_conv", params["global_conv"])
    for name in ("global_bn", "fusion_bn"):
        out.norm(name, params[name], batch_stats[name])
    out.dense("fusion_dense", params["fusion_dense"])
    out.dense("output_dense", params["output_dense"])
    return out.sd


_FAMILIES = {
    "tonet": tonet_state_dict,
    "ftanet": ftanet_state_dict,
    "msnet": msnet_state_dict,
    "jdc": jdc_state_dict,
    "dcnet": dcnet_state_dict,
}


def convert(family: str, params, batch_stats) -> tuple[dict, dict]:
    """(flax params, batch stats) of `family` -> (state_dict, the model's
    constructor arguments that the params fix)."""
    if family not in _FAMILIES:
        raise ValueError(f"no weight conversion for family {family!r}; have {sorted(_FAMILIES)}")
    kwargs = tonet_kwargs(params) if family == "tonet" else {}
    return _FAMILIES[family](params, batch_stats), kwargs
