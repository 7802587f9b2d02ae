"""JDC app (reference jdc/kum_m2m3.py), inference configuration: 31-frame
STFT chunks in batches of 64, the re-referenced pitch logits and the
combined voicing head (counterpart of viterbi_spl_tpu/apps/jdc.py's
config())."""

from __future__ import annotations

from ..families import family_spec
from ..models import JDC
from .common import AppConfig


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("jdc"),
        make_model=lambda **kw: JDC(**kw),
        logits_adapter=lambda out: out["pitch"][..., 1:] - out["pitch"][..., :1],
        snippet_len=31,
        batch_size=64,
        fixed_chunks=True,
    )
