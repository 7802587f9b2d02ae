"""The yardstick's arithmetic: the chip's published peaks, the least time a
piece of work can take, and the work of each piece counted from its shapes.

The peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W: HBM3
at 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores (the
models run with TF32 off). `bound`, `forward_work`, `backtrace_work` and
`obs_work` are frozen copies of the kernel accounting in chip_smoke.py
(`bound`, `work`, `obs_work`): each input byte read once, each output byte
written once, and the float32 operations these inputs' lengths need.
TONet's forward operations are counted by torch's FLOP counter over the
reference model on the meta device, at the configuration's widths.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_flops_per_s": FP32_OPS_PER_S}


def bound(nbytes: float, ops: float) -> float:
    """Least seconds: the larger of bytes over the memory rate and float32
    operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def inband_pairs(n_bins: int, d_max: int) -> int:
    """Source-target pairs inside the band of the voiced block."""
    return sum(min(d_max, n_bins - 1 - s) - max(-d_max, -s) + 1 for s in range(n_bins))


def forward_work(S: int, d_max: int, lengths) -> tuple[int, int]:
    """(bytes, ops) of the banded forward DP fed log observations: the
    observations read and t1m1 written once; per step the in-band add and
    max, the seed (2 adds, 1 max), the observation add, the voiced max and
    the unvoiced target's 4 operations."""
    lengths = np.asarray(lengths, np.int64)
    frames, steps = int(lengths.sum()), int((lengths - 1).sum())
    n = S - 1
    return 2 * frames * 4 * S, steps * (2 * inband_pairs(n, d_max) + 4 * n + n + 4)


def backtrace_work(S: int, lengths) -> tuple[int, int]:
    """(bytes, ops) of the backtrace: a t1m1 row a step read, the states
    written; one add and one compare per candidate."""
    lengths = np.asarray(lengths, np.int64)
    frames, steps = int(lengths.sum()), int((lengths - 1).sum())
    return steps * 4 * S + frames * 4, steps * 2 * S


def obs_work(n_bins: int, spw: int, frames: int, peaks: int) -> tuple[int, int]:
    """(bytes, ops) of the shaun observation model over `frames` frames:
    logits read and log observations written once; per bin the two window
    maxima and the peak test (2 spw + 1), per peak the exp, its sum and the
    output arithmetic (6)."""
    return frames * (2 * n_bins + 1) * 4, frames * n_bins * (2 * spw + 1) + 6 * peaks


def fused_forward_bound(S, d_max, spw, lengths, peaks) -> float:
    """Least seconds of the observation model and the forward DP together:
    the logits read and t1m1 written once (the observation model's bytes),
    both parts' operations."""
    frames = int(np.sum(lengths))
    o_bytes, o_ops = obs_work(S - 1, spw, frames, peaks)
    return bound(o_bytes, forward_work(S, d_max, lengths)[1] + o_ops)


def decode_bound(S, d_max, spw, lengths, peaks) -> float:
    """Least seconds of a whole decode, whatever kernels do it: the larger
    of (logits read once + states written once) over the memory rate and
    (observation model + forward DP + backtrace operations) over the
    float32 rate."""
    frames = int(np.sum(lengths))
    _, o_ops = obs_work(S - 1, spw, frames, peaks)
    ops = o_ops + forward_work(S, d_max, lengths)[1] + backtrace_work(S, lengths)[1]
    return bound(frames * ((S - 1) * 4 + 4), ops)


def model_flops(model: torch.nn.Module, example: torch.Tensor) -> int:
    """Forward FLOPs (2 a multiply-add, matrix products and convolutions)
    of `model` on `example`, both on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(example)
    return int(counter.get_total_flops())


def tonet_flops_per_frame(model_kwargs: dict) -> float:
    """TONet's forward FLOPs a frame: one seg_frame chunk over its frames."""
    from .reference.tonet import TONet

    seg = int(model_kwargs.get("seg_frame", 128))
    with torch.device("meta"):
        model = TONet(**model_kwargs)
        example = torch.empty(1, 3, int(model_kwargs.get("freq_bin", 360)), seg)
    return model_flops(model.eval(), example) / seg
