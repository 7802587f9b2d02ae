"""DCNet app (reference dcnet/main.py / softmax_viterbi.py), inference
configuration: whole 1200-frame snippets of the 500-bin NSGT feature, one
at a time, a ragged last snippet at its own length (counterpart of
viterbi_spl_tpu/apps/dcnet.py's config())."""

from __future__ import annotations

from ..families import family_spec
from ..models import DCNet
from .common import AppConfig


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("dcnet"),
        make_model=lambda **kw: DCNet(**kw),
        logits_adapter=lambda out: out,
        snippet_len=1200,
        batch_size=1,
    )
