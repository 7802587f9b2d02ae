"""TONet app (reference tonet/main_shaun.py), inference configuration:
128-frame tonet-CFP chunks into the dual-backbone TONet, normalized by each
track's own chunk statistics (counterpart of viterbi_spl_tpu/apps/tonet.py's
config())."""

from __future__ import annotations

from ..families import family_spec
from ..models import TONet
from .common import AppConfig


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
        logits_adapter=_logits_adapter,
        snippet_len=128,
        batch_size=4,
        fixed_chunks=True,
        eval_batch_stats=True,
        input_adapter=_input_adapter,
    )
