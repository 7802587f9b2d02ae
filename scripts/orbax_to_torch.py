"""A JAX package checkpoint -> the PyTorch port's checkpoint file.

Reads the orbax checkpoint directory that viterbi_spl_tpu's Trainer writes
(params, batch_stats, opt_state and the scalars), carries the model's
weights across with viterbi_spl_tpu_torch/models/convert.py, and writes the
file viterbi_spl_tpu_torch/harness/train.py::restore_checkpoint reads (the
optimizer state is left behind: the port does not train yet).

    python scripts/orbax_to_torch.py --family tonet ckpts/tonet tonet.pt

Needs jax, flax and orbax beside torch; the port itself needs none of them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.harness.train import TrainState, save_checkpoint  # noqa: E402
from viterbi_spl_tpu_torch.models.convert import convert  # noqa: E402


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def orbax_to_torch(family: str, ckpt_dir, out) -> dict:
    """Convert one checkpoint; returns the model's constructor arguments
    that its params fix (written into the file too)."""
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(Path(ckpt_dir).absolute())
    params, batch_stats = _numpy_tree(tree["params"]), _numpy_tree(tree.get("batch_stats", {}))
    state_dict, model_kwargs = convert(family, params, batch_stats)
    s = tree["scalars"]
    state = TrainState(
        params={}, batch_stats={},
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
