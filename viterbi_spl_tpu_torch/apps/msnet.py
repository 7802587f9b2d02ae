"""MSNet app (reference msnet/hsieh_m2m3.py; counterpart of
viterbi_spl_tpu/apps/msnet.py): whole 1200-frame CFP snippets at batch 1,
smoothed 321-class softmax CE; inference one snippet at a time.

Run: python -m viterbi_spl_tpu_torch.apps.msnet train --synthetic --debug
"""

from __future__ import annotations

from ..families import family_spec
from ..models import MSNet, softmax_smoothed_loss
from .common import AppConfig, app_main, medleydb_datasets


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("msnet"),
        make_model=lambda **kw: MSNet(**kw),
        loss_fn=softmax_smoothed_loss,
        logits_adapter=lambda out: out[..., 1:] - out[..., :1],
        snippet_len=1200,
        batch_size=1,
        learning_rate=1e-4,
        feature_shape=(320, 3),
        supports_valid_frames=True,
    )


def build_real_datasets(debug: bool = False, device=None):
    """MedleyDB on the msnet CFP front-end (44.1 kHz)."""
    return medleydb_datasets("msnet", debug, device)


def main(argv=None):
    return app_main(config(), build_real_datasets, argv)


if __name__ == "__main__":
    main()
