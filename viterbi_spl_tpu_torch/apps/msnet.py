"""MSNet app (reference msnet/hsieh_m2m3.py), inference configuration:
1200-frame CFP snippets, one at a time (counterpart of
viterbi_spl_tpu/apps/msnet.py's config())."""

from __future__ import annotations

from ..families import family_spec
from ..models import MSNet
from .common import AppConfig


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("msnet"),
        make_model=lambda **kw: MSNet(**kw),
        logits_adapter=lambda out: out[..., 1:] - out[..., :1],
        snippet_len=1200,
        batch_size=1,
    )
