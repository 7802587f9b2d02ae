"""FTANet app (reference ftanet/yu.py), inference configuration: 128-frame
CFP chunks, normalized by each track's own chunk statistics (counterpart of
viterbi_spl_tpu/apps/ftanet.py's config())."""

from __future__ import annotations

from ..families import family_spec
from ..models import FTANet
from .common import AppConfig


def config() -> AppConfig:
    return AppConfig(
        family=family_spec("ftanet"),
        make_model=lambda **kw: FTANet(**kw),
        logits_adapter=lambda out: out[..., 1:] - out[..., :1],
        snippet_len=128,
        batch_size=16,
        fixed_chunks=True,
        eval_batch_stats=True,
    )
