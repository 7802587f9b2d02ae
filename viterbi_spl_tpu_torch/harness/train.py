"""The training state and its checkpoint file (counterpart of the state half
of viterbi_spl_tpu/harness/train.py: its Trainer, the epoch loop with early
stopping, waits for the training slice).

The checkpoint is one file written with torch.save: the model family and
the constructor arguments its params fix, the params and BatchNorm
statistics (state_dict tensors), and the scalars the JAX package's
TrainState carries (the validated voicing threshold, epoch, best OA, best
epoch, step). `scripts/orbax_to_torch.py` writes one from a JAX package
checkpoint; `restore_checkpoint` reads it with weights_only=True (tensors,
numbers and strings only).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import torch

CHECKPOINT_FORMAT = "viterbi_spl_tpu_torch.checkpoint/1"


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> tensor (the model's nn.Parameters)
    batch_stats: dict  # name -> tensor (the BatchNorm running averages)
    voicing_threshold: float = 0.5
    epoch: int = 0
    best_oa: float = -1.0
    best_epoch: int = -1
    step: int = 0


def split_state_dict(model: torch.nn.Module) -> tuple[dict, dict]:
    """A model's persistent state -> (params, batch_stats)."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    batch_stats = {k: v for k, v in model.state_dict().items() if k not in params}
    return params, batch_stats


def save_checkpoint(path: str | os.PathLike, state: TrainState, family: str,
                    model_kwargs: dict | None = None) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(
        format=CHECKPOINT_FORMAT,
        family=family,
        model_kwargs=dict(model_kwargs or {}),
        params={k: v.detach().cpu() for k, v in state.params.items()},
        batch_stats={k: v.detach().cpu() for k, v in state.batch_stats.items()},
        scalars=dict(voicing_threshold=float(state.voicing_threshold), epoch=int(state.epoch),
                     best_oa=float(state.best_oa), best_epoch=int(state.best_epoch),
                     step=int(state.step)),
    ), str(path))


def restore_checkpoint(path: str | os.PathLike) -> tuple[TrainState, str, dict]:
    """-> (TrainState with CPU tensors, family, model_kwargs)."""
    ck = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(ck, dict) or ck.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} file")
    state = TrainState(params=ck["params"], batch_stats=ck["batch_stats"], **ck["scalars"])
    return state, ck["family"], ck["model_kwargs"]
