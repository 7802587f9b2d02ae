"""DCNet app (reference dcnet/main.py / softmax_viterbi.py; counterpart of
viterbi_spl_tpu/apps/dcnet.py): whole 1200-frame snippets of the 500-bin
NSGT feature at batch 1, per-bin BCE, manual weight decay 2e-4 on the
global conv kernel; inference one snippet at a time, a ragged last snippet
at its own length.

Run: python -m viterbi_spl_tpu_torch.apps.dcnet train --synthetic --debug
"""

from __future__ import annotations

from ..families import family_spec
from ..models import DCNet, dcnet_loss
from .common import AppConfig, app_main, external_datasets, medleydb_datasets


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("dcnet"),
        make_model=lambda **kw: DCNet(**kw),
        loss_fn=dcnet_loss,
        logits_adapter=lambda out: out,
        snippet_len=1200,
        batch_size=1,
        learning_rate=1e-4,
        feature_shape=(500,),
        supports_valid_frames=True,
        # manual wd=2e-4 on the global conv kernel only, applied to the
        # gradient every step (dcnet/softmax_viterbi.py:311 + :3426)
        weight_decay=(DCNet.global_conv_kernel_name(), 2e-4),
    )


def build_real_datasets(debug: bool = False, device=None):
    """MedleyDB on the NSGT front-end (the 256-hop grid of the labels)."""
    return medleydb_datasets("dcnet", debug, device)


def build_external_datasets(debug: bool = False, device=None):
    """adc04/mirex05/mir1k/rwc on the NSGT front-end (44.1 kHz; dcnet/main.py
    TFDatasetForAdc04..ForRWC)."""
    return external_datasets("dcnet", debug, device)


def main(argv=None):
    return app_main(config(), build_real_datasets, argv,
                    build_external_datasets=build_external_datasets)


if __name__ == "__main__":
    main()
