"""JDC app (reference jdc/kum_m2m3.py; counterpart of
viterbi_spl_tpu/apps/jdc.py): 64 x 31-frame STFT chunks, 722-class CE +
voicing BCE + l2(1e-5) on the first convs and the voicing conv. Validation
and the raw path score the combined voicing head; the re-referenced pitch
logits feed the Viterbi path.

Run: python -m viterbi_spl_tpu_torch.apps.jdc train --synthetic --debug
"""

from __future__ import annotations

from ..families import family_spec
from ..models import JDC, jdc_loss
from .common import AppConfig, app_main, external_datasets, medleydb_datasets


def _loss(notes, out):
    return jdc_loss(notes, out["pitch"], out["voicing"])


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("jdc"),
        make_model=lambda **kw: JDC(**kw),
        loss_fn=_loss,
        logits_adapter=lambda out: out["pitch"][..., 1:] - out["pitch"][..., :1],
        snippet_len=31,
        batch_size=64,
        learning_rate=1e-4,
        feature_shape=(513,),
        fixed_chunks=True,
        # the reference's conv kernels carry l2(1e-5) regularizers that
        # enter the training loss (jdc/acoustic_module.py:35,39,64)
        l2_reg=(JDC.l2_param_names(), 1e-5),
        # the combined voicing head drives the raw path's voicing decision
        # and the validation threshold grid (jdc/acoustic_module.py:74-81)
        voicing_adapter=lambda out: out["voicing"],
    )


def build_real_datasets(debug: bool = False, device=None):
    """MedleyDB on the jdc STFT front-end (8 kHz) with 10 ms labels."""
    return medleydb_datasets("jdc", debug, device)


def build_external_datasets(debug: bool = False, device=None):
    """adc04/mirex05/mir1k/rwc on the jdc STFT front-end (8 kHz) with 10 ms
    labels (jdc/kum_m2m3.py dataset classes)."""
    return external_datasets("jdc", debug, device)


def main(argv=None):
    return app_main(config(), build_real_datasets, argv,
                    build_external_datasets=build_external_datasets)


if __name__ == "__main__":
    main()
