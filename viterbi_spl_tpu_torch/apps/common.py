"""Shared application template, inference half (counterpart of the inference
part of viterbi_spl_tpu/apps/common.py: AppConfig's inference fields,
init_model and the ordered inference over a dataset; training, validation
and the apps' main loop wait for the training slice).

A model runs on the device its params lie on. With the float32 compute
dtype its convolutions and matrix products run in float32 on the card
(`float32_math`: cuDNN's TF32 off, as PyTorch leaves it on by default for
convolutions), so that its logits stay within float32 rounding of the CPU's
and of the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..data.snippets import chunk_fixed, inference_snippets
from ..families import FamilySpec
from ..harness.train import TrainState, split_state_dict


@dataclasses.dataclass
class AppConfig:
    family: FamilySpec
    make_model: Callable[..., torch.nn.Module]  # accepts dtype=... (compute dtype)
    logits_adapter: Callable  # model output -> [B, T, n_bins] pitch logits
    snippet_len: int
    batch_size: int
    # fixed-input models (ftanet/jdc/tonet) require exactly snippet_len
    # frames: inference zero-pads chunks (chunk_fixed) instead of serving a
    # ragged final snippet
    fixed_chunks: bool = False
    # inference normalizes with the track's own chunk-batch statistics
    # instead of the BN running averages (ftanet and tonet: their stacked
    # attention modules only function under per-batch normalization; see
    # the JAX package's AppConfig.eval_batch_stats). No dropout runs.
    eval_batch_stats: bool = False
    # transform from the [B, T, ...] snippet layout to the model's input
    # layout (tonet wants [B, 3, 360, T])
    input_adapter: Callable | None = None
    # mixed precision: compute dtype of the model's convs/denses/LSTMs
    # (params, BatchNorm statistics and logits stay float32)
    compute_dtype: torch.dtype = torch.float32


def float32_math(device) -> contextlib.AbstractContextManager:
    """float32 convolutions and matrix products on a CUDA device (no TF32);
    nothing to change on the CPU."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


def init_model(cfg: AppConfig, model_kwargs: dict | None = None, seed: int = 0, device=None):
    """The family's model at the compute dtype, its params drawn from a
    seeded torch generator, on `device` (the CPU by default) -> (model,
    params, batch_stats)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cfg.make_model(dtype=cfg.compute_dtype, **(model_kwargs or {}))
    model = model.to(device or "cpu").eval()
    params, batch_stats = split_state_dict(model)
    return model, params, batch_stats


def load_state(model: torch.nn.Module, state: TrainState) -> None:
    """A TrainState's params and batch stats into the model (strict)."""
    model.load_state_dict({**state.params, **state.batch_stats}, strict=True)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _forward(cfg: AppConfig, model, batch_stats: bool):
    """The inference forward: the input adapter, then the model without
    autograd, normalized by its running averages or (batch_stats, the
    apps' eval_batch_stats) by the batch's own statistics, running
    averages untouched and no dropout."""

    @torch.no_grad()
    def fwd(spec: np.ndarray):
        x = torch.as_tensor(np.ascontiguousarray(spec), device=_device(model))
        if cfg.input_adapter is not None:
            x = cfg.input_adapter(x)
        return model(x, batch_stats=batch_stats)

    return fwd


def model_logits_for_dataset(cfg: AppConfig, model, dataset) -> list[np.ndarray]:
    """Ordered inference over a dataset -> per-track pitch logits [T, n_bins]
    (float32 NumPy), with the weights the model holds.

    Fixed-chunk models run a track's chunks together: in one batch under
    eval_batch_stats (the track's own statistics), else in batches of
    cfg.batch_size (each chunk independent, as the JAX package's one chunk
    at a time). Other models run one snippet at a time, a ragged last one
    at its own length."""
    model.eval()

    def logits(out):
        return cfg.logits_adapter(out).to(torch.float32).cpu().numpy()

    out_list = []
    with float32_math(_device(model)) if cfg.compute_dtype == torch.float32 \
            else contextlib.nullcontext():
        if cfg.fixed_chunks:
            fwd = _forward(cfg, model, batch_stats=cfg.eval_batch_stats)
            for track in dataset.tracks:
                chunks, _, T = chunk_fixed(track.spectrogram, track.notes, cfg.snippet_len)
                step = len(chunks) if cfg.eval_batch_stats else cfg.batch_size
                lg = np.concatenate([logits(fwd(chunks[i:i + step]))
                                     for i in range(0, len(chunks), step)], axis=0)
                out_list.append(lg.reshape(-1, lg.shape[-1])[:T])
            return out_list

        fwd = _forward(cfg, model, batch_stats=False)
        per_track: dict[int, list] = {}
        for item in inference_snippets(dataset, cfg.snippet_len):
            per_track.setdefault(item["rec_idx"], []).append(logits(fwd(item["spectrogram"][None]))[0])
    return [np.concatenate(per_track[i], axis=0)[: dataset[i].num_frames]
            for i in range(len(dataset))]
