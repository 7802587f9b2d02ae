"""TONet app (reference tonet/main_shaun.py; counterpart of
viterbi_spl_tpu/apps/tonet.py): 128-frame tonet-CFP chunks at batch 4 into
the dual-backbone TONet, mean-of-3-CE pitch/chroma/octave loss under the
reference's warm-up/decay schedule; inference normalized by each track's
own chunk statistics.

Run: python -m viterbi_spl_tpu_torch.apps.tonet train --synthetic --debug
     [--backbone ftanet|mcdnn|msnet|mldrnet] [--mode all|spat|spl|tcfp|single]
"""

from __future__ import annotations

import numpy as np

from ..families import family_spec
from ..models import TONet, tonet_loss
from .common import AppConfig, app_main, medleydb_datasets


def tonet_lr_schedule(base_lr: float, steps_per_epoch: int):
    """The reference's scheduler (tonet/main_shaun.py configure_optimizers):
    0.5x warm-up for 5 epochs, then 0.5 * 0.98^(epoch-5) decay, keyed on
    the optimizer's update count; float32 arithmetic, as the JAX
    package's."""
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        decay = np.float32(0.98) ** np.float32(max(epoch - 5, 0))
        scale = np.float32(0.5) if epoch < 5 else np.float32(0.5) * decay
        return float(np.float32(base_lr) * scale)

    return schedule


def _input_adapter(spec):
    # snippet layout [B, T, 3, 360] -> model layout [B, 3, 360, T]
    return spec.permute(0, 2, 3, 1)


def _logits_adapter(out):
    pitch = out["pitch"].transpose(1, 2)  # [B, T, 361]
    return pitch[..., 1:] - pitch[..., :1]


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("tonet"),
        make_model=lambda **kw: TONet(**kw),
        loss_fn=tonet_loss,
        logits_adapter=_logits_adapter,
        snippet_len=128,
        batch_size=4,
        learning_rate=1e-4,
        feature_shape=(3, 360),
        fixed_chunks=True,
        # like ftanet, the attention/transformer branches only function
        # under per-batch normalization (the JAX package's
        # AppConfig.eval_batch_stats)
        eval_batch_stats=True,
        input_adapter=_input_adapter,
        # the original module's warm-up/decay schedule feeds the optimizer
        # (tonet/model/tonet.py:474-490 configure_optimizers)
        lr_schedule=tonet_lr_schedule,
    )


def build_real_datasets(debug: bool = False, device=None, labels: str = "m2m3"):
    """MedleyDB on the tonet CFP front-end ([T, 3, 360] layout). labels:
    'm2m3' derives them from MELODY2 + vocal sections; 'yu' consumes Yu's
    precomputed 10 ms f0 references from $fatnet_spec/f0ref."""
    return medleydb_datasets("tonet", debug, device, labels=labels)


def main(argv=None):
    """TONet app with the reference's ablation axes: --backbone and --mode
    (tonet/model/tonet.py:24-265) become the model's constructor arguments
    (written into the checkpoint), --labels picks the label source;
    everything else flows to the shared app template."""
    import argparse
    import sys

    from ..models.tonet import TONET_BACKBONES, TONET_MODES

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--backbone", default="ftanet", choices=TONET_BACKBONES,
                     help="acoustic backbone for both branches")
    pre.add_argument("--mode", default="all", choices=TONET_MODES,
                     help="TONet ablation mode: all (dual+transformer), "
                          "spat (single+transformer), spl (single+linear), "
                          "tcfp (dual, direct fusion), single (bare "
                          "backbone)")
    pre.add_argument("--labels", default="m2m3", choices=("m2m3", "yu"),
                     help="label source: m2m3 (MedleyDB MELODY2 + vocal "
                          "sections) or yu (precomputed $fatnet_spec/f0ref "
                          "references, tonet/main_shaun.py:386-406)")
    known, rest = pre.parse_known_args(argv if argv is not None else sys.argv[1:])
    model_kwargs = {}
    if known.backbone != "ftanet":
        model_kwargs["backbone"] = known.backbone
    if known.mode != "all":
        model_kwargs["mode"] = known.mode

    def build_datasets(debug=False, device=None):
        return build_real_datasets(debug=debug, device=device, labels=known.labels)

    return app_main(config(), build_datasets, rest, model_kwargs=model_kwargs)


if __name__ == "__main__":
    main()
