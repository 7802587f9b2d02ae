"""How well float32 can hold a training step: the port's own train step
(apps/common.py::make_train_step) in float32 against the same step in
float64, from the same weights and batch, dropout off, for each NN family at
the sizes tests/test_torch_apps.py trains them (every model at its app
width, TONet at attn_dim 32; 96-frame synthetic tracks; ftanet and TONet
in 16-frame chunks, jdc at batch 8).

Prints, per family: the loss's relative difference, the whole gradient's
relative L2 difference, the largest difference of any tensor over that
tensor's own largest |g| (and which tensor), and over the whole gradient's
largest |g|. These bound what any float32 comparison of gradients (the
port against the JAX package, the card against the CPU) can show.

    python scripts/train_precision_probe.py [family ...]

Runs on the CPU; needs neither jax nor a card.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.apps import common as AC  # noqa: E402

FAMILIES = ("dcnet", "msnet", "ftanet", "jdc", "tonet")
CUT = dict(dcnet={}, msnet={}, ftanet=dict(snippet_len=16), jdc=dict(batch_size=8),
           tonet=dict(snippet_len=16))


def gradients(family: str, dtype) -> tuple[float, dict]:
    mod = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}")
    cfg = dataclasses.replace(mod.config(), compute_dtype=dtype, **CUT[family])
    model, _, _ = AC.init_model(cfg, dict(attn_dim=32) if family == "tonet" else None, seed=3)
    model = model.to(dtype)
    params, stats = AC.split_state_dict(model)
    opt = AC.make_optimizer(cfg, model, 8)
    step = AC.make_train_step(cfg, model)
    train = AC.synthetic_dataset(cfg, 2, 96, 0)
    batch = next(AC.training_batches(cfg, train, np.random.default_rng(0), "cpu"))
    loss = step(params, stats, opt, batch, 0, 0.5)[3]
    return float(loss), {k: p.grad.double() for k, p in params.items() if p.grad is not None}


def main(argv=None) -> int:
    families = (argv if argv is not None else sys.argv[1:]) or FAMILIES
    dropout_generator = AC.dropout_generator
    AC.dropout_generator = lambda *args, **kwargs: None  # dropout off
    try:
        for family in families:
            l32, g32 = gradients(family, torch.float32)
            l64, g64 = gradients(family, torch.float64)
            flat32 = torch.cat([g32[k].flatten() for k in g64])
            flat64 = torch.cat([g.flatten() for g in g64.values()])
            own = {k: float((g32[k] - g).abs().max() / g.abs().max().clamp_min(1e-300))
                   for k, g in g64.items()}
            worst = max(own, key=own.get)
            print(json.dumps({
                "family": family, "loss_rel": abs(l32 - l64) / abs(l64),
                "grad_rel_l2": float((flat32 - flat64).norm() / flat64.norm()),
                "worst_tensor": worst, "worst_over_own_max": own[worst],
                "max_over_global_max": float((flat32 - flat64).abs().max() / flat64.abs().max()),
            }), flush=True)
    finally:
        AC.dropout_generator = dropout_generator
    return 0


if __name__ == "__main__":
    sys.exit(main())
