"""Voicing-threshold calibration tooling (counterpart of
viterbi_spl_tpu/harness/threshold.py).

Re-design of the reference's threshold-sweep scripts (ftanet/threshold.py,
jdc/determine_threshold_kum_m2m3.py, tonet/determine_threshold.py,
tonet/hard_thresholding_vs_automatic_thresholding.py): sweep the raw-path
voicing threshold over the validation grid, report per-threshold voicing
accuracy / OA, pick the argmax, and compare a fixed ("hard") threshold
against the automatically selected one. The counts run in PyTorch on the
setup's device; every decode goes through `DecoderSetup.decode_batch` (the
kernels on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..metrics.melody import MelodyMetrics, est_notes_interp, frame_counts
from .evaluate import DecoderSetup, evaluate_posteriorgrams


def sweep_voicing_thresholds(
    setup: DecoderSetup,
    tracks: Sequence[dict],
    thresholds: np.ndarray | None = None,
) -> dict:
    """Raw-path sweep over a threshold grid.

    tracks: dicts with logits [T, n_bins] and notes [T].
    Returns dict(thresholds, va [K], oa [K], best_threshold, best_oa_threshold,
    metrics).

    With setup.threshold_is_logit (imm), the voicing score is the raw max
    frame logit (a log energy) and the default grid is the probability grid
    mapped through log(p/(1-p)), the reference's imm calibration
    (imm/thresholding.py:156-347; the published 2.442347 is logit(0.92)).
    best_threshold is then in the logit domain, directly usable as
    DecoderSetup.voicing_threshold.
    """
    n = len(tracks)
    if thresholds is None:
        if setup.threshold_is_logit:
            t = np.arange(0.01, 1.0, 0.01, dtype=np.float64)
            t = np.log(t / (1.0 - t)).astype(np.float32)
            mm = MelodyMetrics(n, t)
        else:
            mm = MelodyMetrics.validation_grid(n)
    else:
        mm = MelodyMetrics(n, np.asarray(thresholds, np.float32))

    dev = setup.device
    f32 = torch.float32
    for rec_idx, track in enumerate(tracks):
        logits = torch.as_tensor(np.asarray(track["logits"], np.float32), device=dev)
        T, n_bins = logits.shape
        probs = torch.sigmoid(logits)
        peak_idx = torch.argmax(probs, dim=1)  # the first maximum, as jnp.argmax
        if track.get("voicing_logits") is not None:
            # a separate voicing head (jdc) supplies the thresholded score
            voicing_probs = torch.sigmoid(
                torch.as_tensor(np.asarray(track["voicing_logits"]), dtype=f32, device=dev))
        elif setup.threshold_is_logit:
            # imm: thresholds compare against raw max log energies
            # (harness/evaluate.py raw path, imm/thresholding.py:293)
            voicing_probs = logits.amax(dim=1)
        else:
            voicing_probs = torch.gather(probs, 1, peak_idx[:, None])[:, 0]
        if setup.interp_est_notes:
            est_notes = est_notes_interp(peak_idx, probs, setup.note_min,
                                         setup.bins_per_semitone, n_bins)
        else:
            grid = setup.note_min + torch.arange(n_bins, dtype=f32, device=dev) / \
                setup.bins_per_semitone
            est_notes = grid[peak_idx]
        counts = frame_counts(
            torch.as_tensor(np.asarray(track["notes"]), dtype=f32, device=dev),
            est_notes, voicing_probs, torch.as_tensor(mm.thresholds, device=dev),
        )
        mm.update(rec_idx, {k: v.cpu().numpy() for k, v in counts.items()})

    K = len(mm.thresholds)
    va = np.empty(K, np.float32)
    oa = np.empty(K, np.float32)
    for k in range(K):
        res = mm.results(k)
        va[k] = res["va"].mean()
        oa[k] = res["oa"].mean()
    _, best_va_th = mm.best_voicing_threshold()
    return dict(
        thresholds=np.asarray(mm.thresholds),
        va=va,
        oa=oa,
        best_threshold=best_va_th,  # the reference selects on VA (:2179-2207)
        best_oa_threshold=float(mm.thresholds[int(np.argmax(oa))]),
        metrics=mm,
    )


def hard_vs_auto(
    setup: DecoderSetup,
    validation_tracks: Sequence[dict],
    test_tracks: Sequence[dict],
    hard_threshold: float,
) -> dict:
    """The tonet hard-vs-automatic ablation: evaluate the test split with a
    fixed threshold vs the validation-selected one."""
    sweep = sweep_voicing_thresholds(setup, validation_tracks)
    auto_setup = dataclasses.replace(setup, voicing_threshold=sweep["best_threshold"])
    hard_setup = dataclasses.replace(setup, voicing_threshold=hard_threshold)
    return dict(
        auto_threshold=sweep["best_threshold"],
        auto=evaluate_posteriorgrams(auto_setup, test_tracks),
        hard=evaluate_posteriorgrams(hard_setup, test_tracks),
    )


def sweep_obs_hyperparams(
    setup: DecoderSetup,
    tracks: Sequence[dict],
    ps: Sequence[float] = (0.6, 0.7, 0.8, 0.9),
    scales: Sequence[float] = (1.0, 2.0, 4.0),
) -> dict:
    """The tonet/hyper_parameter_selection.py sweep: grid over the shaun
    observation model's (p, scale), scored by mean Viterbi OA. The reference
    selected p=0.8, scale=2 on validation (dcnet/softmax_viterbi.py:41-50)."""
    results = np.zeros((len(ps), len(scales)), np.float32)
    for i, p in enumerate(ps):
        for j, s in enumerate(scales):
            cfg = dataclasses.replace(setup, obs_p=float(p), obs_scale=float(s))
            results[i, j] = evaluate_posteriorgrams(cfg, tracks)["viterbi_mean_oa"]
    best = np.unravel_index(int(np.argmax(results)), results.shape)
    return dict(
        ps=list(ps), scales=list(scales), oa=results,
        best_p=float(ps[best[0]]), best_scale=float(scales[best[1]]),
    )
