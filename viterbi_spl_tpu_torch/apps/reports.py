"""Calibration experiment modes shared by the family apps (counterpart of
viterbi_spl_tpu/apps/reports.py).

Each mode reproduces one of the reference's standalone sweep scripts on top
of the shared harness tooling (harness/threshold.py; every decode through
DecoderSetup.decode_batch, K1/K2 on the card):

- sweep-threshold: raw-path voicing-threshold sweep over the validation
  grid (ftanet/threshold.py, jdc/determine_threshold_kum_m2m3.py,
  tonet/determine_threshold.py).
- hard-vs-auto: fixed vs validation-selected threshold on the test split
  (tonet/hard_thresholding_vs_automatic_thresholding.py).
- sweep-obs: (p, scale) grid for the shaun observation model scored by
  Viterbi OA (tonet/hyper_parameter_selection.py).
"""

from __future__ import annotations

import numpy as np

from ..harness.threshold import (
    hard_vs_auto,
    sweep_obs_hyperparams,
    sweep_voicing_thresholds,
)


def _tracks_for(cfg, model, dataset):
    # carries voicing_logits when the family has a voicing head (jdc), so
    # the calibration sweeps threshold the same score the raw path uses
    from .common import tracks_for_evaluation

    return tracks_for_evaluation(cfg, model, dataset)


def run_calibration_mode(
    mode: str, cfg, model, datasets, setup, *, hard_threshold: float
):
    """One calibration mode with the weights the model holds."""
    val_tracks = _tracks_for(cfg, model, datasets["validation"])

    if mode == "sweep-threshold":
        out = sweep_voicing_thresholds(setup, val_tracks)
        k = np.linspace(0, len(out["thresholds"]) - 1, 11).astype(int)
        for i in k:
            print(
                f"th={out['thresholds'][i]:.2f}  va={out['va'][i]:.4f}  "
                f"oa={out['oa'][i]:.4f}"
            )
        print(
            f"best (VA-selected) threshold {out['best_threshold']:.2f}; "
            f"best-OA threshold {out['best_oa_threshold']:.2f}"
        )
        return out

    if mode == "hard-vs-auto":
        test_tracks = _tracks_for(cfg, model, datasets["test"])
        out = hard_vs_auto(setup, val_tracks, test_tracks, hard_threshold)
        print(
            f"auto threshold {out['auto_threshold']:.2f}: "
            f"test viterbi OA {out['auto']['viterbi_mean_oa']:.4f} "
            f"(raw {out['auto']['raw_mean_oa']:.4f})"
        )
        print(
            f"hard threshold {hard_threshold:.2f}: "
            f"test viterbi OA {out['hard']['viterbi_mean_oa']:.4f} "
            f"(raw {out['hard']['raw_mean_oa']:.4f})"
        )
        return out

    if mode == "sweep-obs":
        out = sweep_obs_hyperparams(setup, val_tracks)
        for i, p in enumerate(out["ps"]):
            row = "  ".join(f"{v:.4f}" for v in out["oa"][i])
            print(f"p={p:.2f}: {row}")
        print(f"best p={out['best_p']}, scale={out['best_scale']}")
        return out

    raise ValueError(mode)
