"""Harness configuration (counterpart of viterbi_spl_tpu/harness/config.py).

Re-design of the per-script Config classes (dcnet/softmax_viterbi.py:
127-212): a dataclass instead of module constants, with the same
semantics — a train/inference mode switch, snippet length, learning rate,
early-stopping patience, DEBUG split truncation, and the checkpoint/log
collision guards (:195-212).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class TrainOrInference:
    """The reference's argparse.Namespace-as-struct (:136-140):
    - inference: checkpoint path -> inference-only mode
    - from_ckpt: checkpoint path -> resume training
    - ckpt_prefix: name under which new checkpoints are saved
    """

    inference: str | None = None
    from_ckpt: str | None = None
    ckpt_prefix: str = "d0"

    @property
    def is_inference(self) -> bool:
        return self.inference is not None


@dataclasses.dataclass
class HarnessConfig:
    mode: TrainOrInference = dataclasses.field(default_factory=TrainOrInference)
    snippet_len: int = 1200
    learning_rate: float = 1e-4
    batches_per_epoch: int | None = None
    patience_epochs: int = 20
    debug: bool = False
    debug_tracks_per_split: int = 2
    log_dir: str = "runs"
    ckpt_dir: str = "ckpts"
    seed: int = 20260817

    def truncate_split(self, track_ids: list[str]) -> list[str]:
        """DEBUG mode: 1-2 tracks per split for a minutes-long end-to-end
        smoke run (dcnet/softmax_viterbi.py:157-159)."""
        if self.debug:
            return list(track_ids[: self.debug_tracks_per_split])
        return list(track_ids)

    def check_collisions(self) -> None:
        """Refuse to overwrite an existing run of the same prefix
        (chk_if_tb_dir_and_model_with_same_prefix_exist_fn, :195-212)."""
        if self.mode.is_inference:
            return
        prefix = self.mode.ckpt_prefix
        log_path = Path(self.log_dir) / prefix
        if self.mode.from_ckpt is None:
            if log_path.exists():
                raise FileExistsError(f"log dir {log_path} already exists")
            ckpt_path = Path(self.ckpt_dir) / prefix
            if ckpt_path.exists():
                raise FileExistsError(f"checkpoint {ckpt_path} already exists")

    def resolve_ckpt_path(self) -> str:
        return str(Path(self.ckpt_dir).absolute() / self.mode.ckpt_prefix)
