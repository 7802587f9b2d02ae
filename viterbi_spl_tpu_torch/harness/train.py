"""Training loop: the epoch loop with early stopping + checkpointing
(counterpart of viterbi_spl_tpu/harness/train.py).

Re-design of the reference's main()/training_fn/inference_fn template
(dcnet/softmax_viterbi.py:3377-3602):
- epoch loop: train `batches_per_epoch` steps, then validate,
- the validation grid picks the voicing threshold and it is CHECKPOINTED
  with the model (the reference stores it as a tf.Variable, :313, :2179-2207),
- checkpoint saved only when validation OA improves; early stop when
  `epoch - best_epoch >= patience` (:3568-3584),
- resume re-runs validation first to re-establish best_oa
  (reproduce-val-first, :3536-3556).

The Trainer is model-agnostic: it takes a train step, a stream of batches
and a validate callable. In the port a TrainState's params and batch_stats
are the model's own tensors (name -> tensor, `split_state_dict`) and its
opt_state the torch optimizer over them: a step updates them in place and
hands them back, so that the Trainer's protocol is the JAX package's.

The checkpoint is one file written with torch.save: the model family and
the constructor arguments its params fix, the params and BatchNorm
statistics, the optimizer's state_dict, and the scalars of the TrainState
(the validated voicing threshold, epoch, best OA, best epoch, step). A
`--mesh` run's state is written in the same layout: its params and
statistics are replica 0's full tensors, and its optimizer
(dist/train.py::MeshOptimizer) gives its state_dict gathered from the
shards, so that the file restores into a single-device run as into a
mesh, where `restore` re-splits it (`scatter`). With several processes
(utils.initialize_distributed), process 0 writes between two barriers,
and every process restores the same file (the JAX package's
harness/train.py:125-147). Format `viterbi_spl_tpu_torch.checkpoint/2`;
`restore_checkpoint` also reads `/1` files (no optimizer state: resuming one starts the
optimizer afresh, as the JAX package resumes a checkpoint without a step
counter at step 0). It reads with weights_only=True (tensors, numbers,
strings and containers only). `scripts/orbax_to_torch.py` writes one from a
JAX package checkpoint, its Adam state included.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..metrics.melody import MelodyMetrics

CHECKPOINT_FORMAT = "viterbi_spl_tpu_torch.checkpoint/2"
READABLE_FORMATS = (CHECKPOINT_FORMAT, "viterbi_spl_tpu_torch.checkpoint/1")


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> tensor (the model's nn.Parameters)
    batch_stats: dict  # name -> tensor (the BatchNorm running averages)
    # the optimizer over params (a torch.optim.Optimizer), or its state_dict
    # as a checkpoint file holds it (None: no optimizer state)
    opt_state: Any = None
    voicing_threshold: float = 0.5
    epoch: int = 0
    best_oa: float = -1.0
    best_epoch: int = -1
    step: int = 0  # global train-step counter (drives the dropout generator)

    def scalars(self) -> dict:
        return dict(voicing_threshold=float(self.voicing_threshold), epoch=int(self.epoch),
                    best_oa=float(self.best_oa), best_epoch=int(self.best_epoch),
                    step=int(self.step))


def split_state_dict(model: torch.nn.Module) -> tuple[dict, dict]:
    """A model's persistent state -> (params, batch_stats), the model's own
    tensors."""
    params = {k: v for k, v in model.named_parameters()}
    batch_stats = {k: v for k, v in model.state_dict(keep_vars=True).items() if k not in params}
    return params, batch_stats


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str | os.PathLike, state: TrainState, family: str,
                    model_kwargs: dict | None = None) -> None:
    """One file, written beside its final name and then moved there, so that
    a reader never finds half a checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    opt = state.opt_state
    if hasattr(opt, "state_dict"):
        opt = opt.state_dict()
    tmp = path.with_name(path.name + ".tmp")
    torch.save(dict(
        format=CHECKPOINT_FORMAT,
        family=family,
        model_kwargs=dict(model_kwargs or {}),
        params=_to_cpu(state.params),
        batch_stats=_to_cpu(state.batch_stats),
        opt_state=_to_cpu(opt),
        scalars=state.scalars(),
    ), str(tmp))
    os.replace(tmp, path)


def restore_checkpoint(path: str | os.PathLike) -> tuple[TrainState, str, dict]:
    """-> (TrainState with CPU tensors, its opt_state the optimizer's
    state_dict or None, family, model_kwargs)."""
    ck = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(ck, dict) or ck.get("format") not in READABLE_FORMATS:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} file")
    state = TrainState(params=ck["params"], batch_stats=ck["batch_stats"],
                       opt_state=ck.get("opt_state"), **ck["scalars"])
    return state, ck["family"], ck["model_kwargs"]


def _copy_into(live: dict, saved: dict, what: str) -> None:
    if set(live) != set(saved):
        raise ValueError(f"checkpoint {what} differ from the model's: "
                         f"{sorted(set(live) ^ set(saved))[:5]}")
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(saved[k])


class Trainer:
    """The epoch loop.

    train_step(params, batch_stats, opt_state, batch, step[, threshold]) ->
        (params, batch_stats, opt_state, loss[, counts]) — `step` is the
        global step counter (it seeds the dropout generator, so every step
        draws fresh masks, matching the reference's stochastic dropout,
        dcnet/softmax_viterbi.py:3399-3434); `loss` stays on the device
        (the epoch reads all its losses at once). A 6-arg step additionally
        receives the current voicing threshold and returns per-batch
        training-split metric counts (tensors, on the device); the epoch
        sums them on the device and reads them once, into the full VRR..OA
        set (the reference's MetricsTrainingModeTrainingSplit,
        dcnet/softmax_viterbi.py:1599-1850) surfaced as
        info["train_metrics"]. The sixth parameter MUST be literally named
        `threshold` — the metrics protocol is detected by that name (a
        6-arg step without it is treated as the 5-arg protocol, with a
        warning).
    validate(state) -> dict with at least {"oa": float,
        "voicing_threshold": float} (from MelodyMetrics.validation_grid).
    family, model_kwargs: written into the checkpoint beside the state.
    """

    def __init__(
        self,
        train_step: Callable,
        validate: Callable[[TrainState], dict],
        ckpt_path: str | os.PathLike,
        patience_epochs: int = 20,
        max_epochs: int = 10_000,
        family: str = "",
        model_kwargs: dict | None = None,
    ):
        self.train_step = train_step
        self.validate = validate
        self.patience = patience_epochs
        self.max_epochs = max_epochs
        self.ckpt_path = Path(ckpt_path).absolute()
        self.family = family
        self.model_kwargs = dict(model_kwargs or {})
        # the last epoch's steps and their seconds (on_epoch_end's info has them)
        self.last_epoch_steps, self.last_epoch_seconds = 0, 0.0
        # a metrics-reporting step declares a parameter literally named
        # `threshold` (make_train_step does); counting parameters would
        # misread variadic steps or steps with unrelated optional args
        try:
            params = inspect.signature(train_step).parameters
        except (TypeError, ValueError):
            params = {}
        self._step_takes_threshold = "threshold" in params
        if not self._step_takes_threshold and len(params) >= 6:
            logging.warning(
                "train_step has %d parameters but none named 'threshold'; "
                "using the 5-arg protocol (no training-split metrics). "
                "Name the sixth parameter 'threshold' to enable them.",
                len(params),
            )

    # -- checkpointing ---------------------------------------------------
    def save(self, state: TrainState) -> None:
        """One checkpoint, the best so far (max_to_keep=1, like the
        reference). Multi-process safe: process 0 writes the file after a
        barrier (a mesh's optimizer gathers its shards locally: each
        process holds whole data rows), and a final barrier holds everyone
        until the file is in place, so that no process reads or replaces
        it early."""
        from ..utils import process_count, process_index

        multiprocess = process_count() > 1
        if multiprocess:
            import torch.distributed as dist

            dist.barrier()
        if process_index() == 0:
            save_checkpoint(self.ckpt_path, state, self.family, self.model_kwargs)
        if multiprocess:
            dist.barrier()

    def restore(self, state_like: TrainState) -> TrainState:
        """The checkpoint's params, statistics and optimizer state copied
        into state_like's live tensors and optimizer (the model sees them);
        returns a TrainState over them with the checkpoint's scalars. A
        file without optimizer state leaves the optimizer as it is."""
        ck, family, _ = restore_checkpoint(self.ckpt_path)
        if self.family and family != self.family:
            raise ValueError(f"{self.ckpt_path} holds a {family} model, not {self.family}")
        _copy_into(state_like.params, ck.params, "params")
        _copy_into(state_like.batch_stats, ck.batch_stats, "batch stats")
        opt = state_like.opt_state
        if hasattr(opt, "scatter"):  # a mesh's optimizer: the store and replicas
            opt.scatter()
        if ck.opt_state is not None and hasattr(opt, "load_state_dict"):
            opt.load_state_dict(ck.opt_state)
        return dataclasses.replace(ck, params=state_like.params,
                                   batch_stats=state_like.batch_stats, opt_state=opt)

    # -- loops -----------------------------------------------------------
    def train_epoch(
        self, state: TrainState, batches: Iterator[Any], steps: int
    ) -> tuple[TrainState, float, dict | None]:
        losses = []
        count_list = []
        t0 = time.perf_counter()
        for _ in range(steps):
            batch = next(batches)
            if self._step_takes_threshold:
                (state.params, state.batch_stats, state.opt_state, loss,
                 counts) = self.train_step(
                    state.params, state.batch_stats, state.opt_state, batch,
                    state.step, state.voicing_threshold,
                )
                if counts is not None:
                    count_list.append(counts)
            else:
                (state.params, state.batch_stats, state.opt_state,
                 loss) = self.train_step(
                    state.params, state.batch_stats, state.opt_state, batch,
                    state.step,
                )
            state.step += 1
            losses.append(torch.as_tensor(loss))
        # one device->host read for the epoch's losses, one for its counts
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
        # the steps' time, the device's included (the read above waits for it)
        self.last_epoch_steps, self.last_epoch_seconds = steps, time.perf_counter() - t0
        train_metrics = None
        if count_list:
            summed = {k: torch.stack([c[k] for c in count_list]).sum(dim=0)
                      for k in count_list[0]}
            summed = _to_cpu(summed)
            mm = MelodyMetrics(
                1, np.asarray([state.voicing_threshold], np.float32)
            )
            mm.update(0, {k: v.numpy() for k, v in summed.items()}, loss=mean_loss)
            train_metrics = {
                k: (float(v) if np.ndim(v) == 0 else float(np.asarray(v)[0]))
                for k, v in mm.results(0).items()
            }
        return state, mean_loss, train_metrics

    def fit(
        self,
        state: TrainState,
        batches: Iterator[Any],
        steps_per_epoch: int,
        resume: bool = False,
        on_epoch_end: Callable[[TrainState, dict], None] | None = None,
    ) -> TrainState:
        if resume:
            state = self.restore(state)
            # reproduce-val-first: re-establish best_oa from the restored
            # weights before training continues
            val = self.validate(state)
            state.best_oa = val["oa"]
            state.best_epoch = state.epoch
            logging.info("resumed at epoch %d, val oa %.4f", state.epoch, val["oa"])

        while state.epoch < self.max_epochs:
            state, train_loss, train_metrics = self.train_epoch(
                state, batches, steps_per_epoch
            )
            val = self.validate(state)
            state.voicing_threshold = val.get(
                "voicing_threshold", state.voicing_threshold
            )
            improved = val["oa"] > state.best_oa
            if improved:
                state.best_oa = val["oa"]
                state.best_epoch = state.epoch
                self.save(state)
            if on_epoch_end is not None:
                on_epoch_end(
                    state,
                    dict(train_loss=train_loss, val=val, improved=improved,
                         train_metrics=train_metrics, train_steps=self.last_epoch_steps,
                         train_step_seconds=self.last_epoch_seconds),
                )
            if state.epoch - state.best_epoch >= self.patience:
                logging.info(
                    "early stop at epoch %d (best %.4f @ %d)",
                    state.epoch,
                    state.best_oa,
                    state.best_epoch,
                )
                break
            state.epoch += 1
        return state


def add_weight_decay_grad(grads: dict, params: dict, name: str, wd: float) -> dict:
    """Manual weight decay on a single kernel — the dcnet rule
    (dcnet/softmax_viterbi.py:293-364): grad += wd * param, only for the
    global conv kernel. grads, params: name -> tensor; returns new grads."""
    return {**grads, name: grads[name] + wd * params[name]}


def l2_regularization(params: dict, names, scale: float) -> torch.Tensor:
    """sum(scale * ||w||^2) over the named kernels (jdc's l2(1e-5))."""
    return sum(scale * torch.sum(params[n] ** 2) for n in names)
