from .config import HarnessConfig, TrainOrInference
from .evaluate import DecoderSetup, decode_and_score_track, evaluate_posteriorgrams
from .reporting import Reporter, metrics_markdown_table
from .train import Trainer, TrainState

__all__ = [
    "DecoderSetup",
    "HarnessConfig",
    "TrainOrInference",
    "TrainState",
    "Trainer",
    "decode_and_score_track",
    "evaluate_posteriorgrams",
    "Reporter",
    "metrics_markdown_table",
]
