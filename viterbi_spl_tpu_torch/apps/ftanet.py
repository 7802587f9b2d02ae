"""FTANet app (reference ftanet/yu.py; counterpart of
viterbi_spl_tpu/apps/ftanet.py): 16 x 128-frame CFP chunks, smoothed
321-class softmax CE; inference normalized by each track's own chunk
statistics.

Run: python -m viterbi_spl_tpu_torch.apps.ftanet train --synthetic --debug
"""

from __future__ import annotations

from ..families import family_spec
from ..models import FTANet, softmax_smoothed_loss
from .common import AppConfig, app_main, external_datasets, medleydb_datasets


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("ftanet"),
        make_model=lambda **kw: FTANet(**kw),
        loss_fn=softmax_smoothed_loss,
        logits_adapter=lambda out: out[..., 1:] - out[..., :1],
        snippet_len=128,
        batch_size=16,
        learning_rate=1e-4,
        feature_shape=(320, 3),
        fixed_chunks=True,
        eval_batch_stats=True,
    )


def build_real_datasets(debug: bool = False, device=None):
    """MedleyDB on the ftanet CFP front-end (8 kHz) with 10 ms labels."""
    return medleydb_datasets("ftanet", debug, device)


def build_external_datasets(debug: bool = False, device=None):
    """adc04/mirex05/mir1k/rwc on the ftanet CFP front-end (8 kHz) with 10 ms
    labels (ftanet/viterbi_performance.py dataset classes)."""
    return external_datasets("ftanet", debug, device)


def main(argv=None):
    return app_main(config(), build_real_datasets, argv,
                    build_external_datasets=build_external_datasets)


if __name__ == "__main__":
    main()
