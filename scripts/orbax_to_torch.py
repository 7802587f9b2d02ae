"""A JAX package checkpoint -> the PyTorch port's checkpoint file.

Reads the orbax checkpoint directory that viterbi_spl_tpu's Trainer writes
(params, batch_stats, opt_state and the scalars), carries the model's
weights across with viterbi_spl_tpu_torch/models/convert.py, carries
optax's Adam state (its count and its moments mu and nu, converted as the
params are) into the port's optimizer state_dict, and writes the file
viterbi_spl_tpu_torch/harness/train.py::restore_checkpoint reads: a JAX run
can resume in the port (`apps.<family> train --resume --ckpt out.pt`).

    python scripts/orbax_to_torch.py --family tonet ckpts/tonet tonet.pt

Needs jax, flax and orbax beside torch; the port itself needs none of them.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.apps.common import make_optimizer  # noqa: E402
from viterbi_spl_tpu_torch.harness.train import TrainState, save_checkpoint  # noqa: E402
from viterbi_spl_tpu_torch.models.convert import convert  # noqa: E402


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def adam_state_dict(family: str, model_kwargs: dict, adam: dict, batch_stats) -> dict:
    """optax's ScaleByAdamState (count, mu, nu; as orbax restores it without
    a template, a dict) -> the port's optimizer state_dict: one entry per
    trainable param of the family's model, in the optimizer's order
    (apps/common.py::make_optimizer), Adam's step its count."""
    cfg = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}").config()
    with torch.device("meta"):
        model = cfg.make_model(dtype=cfg.compute_dtype, **model_kwargs)
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    mu, _ = convert(family, _numpy_tree(adam["mu"]), batch_stats)
    nu, _ = convert(family, _numpy_tree(adam["nu"]), batch_stats)
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    groups = make_optimizer(cfg, model, steps_per_epoch=1).state_dict()["param_groups"]
    return dict(state={i: dict(step=step.clone(), exp_avg=mu[n], exp_avg_sq=nu[n])
                       for i, n in enumerate(names)},
                param_groups=groups)


def orbax_to_torch(family: str, ckpt_dir, out) -> dict:
    """Convert one checkpoint; returns the model's constructor arguments
    that its params fix (written into the file too)."""
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(Path(ckpt_dir).absolute())
    params, batch_stats = _numpy_tree(tree["params"]), _numpy_tree(tree.get("batch_stats", {}))
    state_dict, model_kwargs = convert(family, params, batch_stats)
    s = tree["scalars"]
    # optax.adam's state is (ScaleByAdamState, EmptyState or, under a
    # schedule, ScaleByScheduleState), restored as a list
    opt = tree.get("opt_state")
    adam = opt[0] if isinstance(opt, (list, tuple)) and isinstance(opt[0], dict) else None
    state = TrainState(
        params={}, batch_stats={},
        opt_state=None if adam is None else adam_state_dict(family, model_kwargs, adam,
                                                            batch_stats),
        voicing_threshold=float(s["voicing_threshold"]), epoch=int(s["epoch"]),
        best_oa=float(s["best_oa"]), best_epoch=int(s["best_epoch"]),
        step=int(s.get("step", 0)),
    )
    # the converted tensors split as the port's modules hold them: BatchNorm
    # statistics (mean, var) are buffers, everything else a parameter
    for k, v in state_dict.items():
        (state.batch_stats if k.endswith((".mean", ".var")) else state.params)[k] = v
    save_checkpoint(out, state, family, model_kwargs)
    return model_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", required=True, choices=["tonet", "ftanet", "msnet", "jdc", "dcnet"])
    ap.add_argument("ckpt", help="the JAX package's orbax checkpoint directory")
    ap.add_argument("out", help="the port's checkpoint file to write")
    args = ap.parse_args(argv)
    kwargs = orbax_to_torch(args.family, args.ckpt, args.out)
    print(f"{args.family} checkpoint written to {args.out} (model arguments {kwargs})")


if __name__ == "__main__":
    main()
