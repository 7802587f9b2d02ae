"""Melody metrics engine in PyTorch (counterpart of
viterbi_spl_tpu/metrics/melody.py).

Re-design of the reference's TF-variable accumulator classes
(MetricsTrainingModeTrainingSplit / MetricsValidation / MetricsInference,
dcnet/softmax_viterbi.py:1599-3230) as functions on tensors producing count
dictionaries, plus a small NumPy accumulator:

- est_notes_interp — probability-weighted note interpolation over the +/-1
  bins around a peak (MetricsBase.est_notes_fn, :1929-1950).
- frame_counts — all per-frame counts for one chunk in one shot, optionally
  against a whole grid of voicing thresholds (:1977-1980).
- MelodyMetrics — per-recording int64 accumulators, float64-safe division,
  best-threshold selection (:2179-2207), and the metric set
  VRR/VFA/VA/RPA(strict/wide)/RCA(strict/wide)/OA (:3056-3158).

Semantics notes (kept identical to the reference):
- ref voicing is ref_note > 0.1; wide metrics ignore the voicing decision;
  strict metrics require est voicing; tolerance is 0.5 semitone; chroma
  folds to the nearest octave (floor(d/12 + .5) * 12).
- est voicing compares the peak probability to the threshold with `>`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def est_notes_interp(est_peak_indices, est_probs, note_min, bins_per_semitone, n_bins):
    """Weighted est-note interpolation over the +/-1 bins around the peak.

    est_peak_indices: [T] int; est_probs: [T, n_bins] (sigmoid probs).
    note(bin) = note_min + bin / bins_per_semitone;
    est_note = sum(note * p, |bin - peak| <= 1) / max(sum p, 1e-3) + offset.
    Only the three bins around each peak are gathered (the JAX package
    masks all n_bins; the sums agree to float32 rounding).
    """
    est_probs = torch.as_tensor(est_probs, dtype=torch.float32)
    dev = est_probs.device
    peak = torch.as_tensor(est_peak_indices).to(dev, torch.int64)
    bps = torch.tensor(bins_per_semitone, dtype=torch.float32, device=dev)
    norm = torch.zeros(peak.shape, dtype=torch.float32, device=dev)
    notes = torch.zeros(peak.shape, dtype=torch.float32, device=dev)
    for k in (-1, 0, 1):
        b = peak + k
        ok = (b >= 0) & (b < n_bins)
        bc = b.clamp(0, n_bins - 1)
        p = torch.where(ok, torch.gather(est_probs, 1, bc[:, None])[:, 0], 0.0)
        norm = norm + p
        notes = notes + bc.to(torch.float32) / bps * p
    return notes / torch.clamp(norm, min=1e-3) + torch.tensor(
        note_min, dtype=torch.float32, device=dev
    )


def octave_fold(distance):
    return torch.floor(distance / 12.0 + 0.5) * 12.0


def frame_counts(ref_notes, est_notes, est_peak_probs, thresholds) -> dict:
    """All accumulator counts for one chunk of frames.

    ref_notes: [T] float (MIDI; 0 = unvoiced). est_notes: [T] float MIDI.
    est_peak_probs: [T] peak probability (drives the voicing decision).
    thresholds: [K] voicing thresholds (K=1 for a fixed threshold).

    Returns a dict of int64 tensors: voiced, unvoiced [scalar];
    correct_voiced, incorrect_voiced, correct_unvoiced,
    correct_pitches_strict, correct_chromas_strict [K];
    correct_pitches_wide, correct_chromas_wide [scalar].
    """
    # float32 throughout, as the JAX package computes (x64 disabled)
    f32 = torch.float32
    est_notes = torch.as_tensor(est_notes, dtype=f32)
    dev = est_notes.device
    ref_notes = torch.as_tensor(ref_notes, dtype=f32).to(dev)
    est_peak_probs = torch.as_tensor(est_peak_probs, dtype=f32).to(dev)
    thresholds = torch.as_tensor(thresholds, dtype=f32).to(dev)
    ref_voicing = ref_notes > 0.1
    n_ref = ~ref_voicing
    est_voicing = est_peak_probs[:, None] > thresholds[None, :]  # [T, K]
    n_est = ~est_voicing

    diffs = torch.abs(est_notes - ref_notes)

    def cnt(x):
        return x.sum(dtype=torch.int64)

    def cnt_k(x):
        return x.sum(dim=0, dtype=torch.int64)

    pitch_ok = diffs < 0.5
    chroma_ok = torch.abs(diffs - octave_fold(diffs)) < 0.5
    cp_wide = ref_voicing & pitch_ok
    cc_wide = ref_voicing & chroma_ok

    return dict(
        voiced=cnt(ref_voicing),
        unvoiced=cnt(n_ref),
        correct_voiced=cnt_k(ref_voicing[:, None] & est_voicing),
        incorrect_voiced=cnt_k(n_ref[:, None] & est_voicing),
        correct_unvoiced=cnt_k(n_ref[:, None] & n_est),
        correct_pitches_wide=cnt(cp_wide),
        correct_pitches_strict=cnt_k(cp_wide[:, None] & est_voicing),
        correct_chromas_wide=cnt(cc_wide),
        correct_chromas_strict=cnt_k(cc_wide[:, None] & est_voicing),
    )


def frame_counts_fixed_voicing(ref_notes, est_notes, est_voicing) -> dict:
    """Counts when the voicing decision is explicit (Viterbi path),
    dcnet/softmax_viterbi.py:2923-2979. Returns the same keys with K=1."""
    est_notes = torch.as_tensor(est_notes, dtype=torch.float32)
    dev = est_notes.device
    probs = torch.where(torch.as_tensor(est_voicing).to(dev), 1.0, 0.0)
    return frame_counts(
        ref_notes, est_notes, probs, torch.tensor([0.5], dtype=torch.float32, device=dev)
    )


def _f8div(num, den):
    """float64-safe division, rounded back to float32 (MetricsBase.
    to_f8_divide_and_to_f4_fn, dcnet/softmax_viterbi.py:1909-1917)."""
    num = np.asarray(num, np.float64)
    den = np.maximum(np.asarray(den, np.float64), 1e-7)
    return (num / den).astype(np.float32)


@dataclasses.dataclass
class MelodyMetrics:
    """Per-recording accumulators over a split.

    num_recs recordings; K voicing thresholds (K=1 -> fixed threshold).
    Call `update(rec_idx, counts)` per chunk, then `results()`.
    """

    num_recs: int
    thresholds: np.ndarray  # [K] float32

    def __post_init__(self):
        self.thresholds = np.atleast_1d(np.asarray(self.thresholds, np.float32))
        K = len(self.thresholds)
        R = self.num_recs
        self._scalar_keys = ("voiced", "unvoiced", "correct_pitches_wide", "correct_chromas_wide")
        self._grid_keys = (
            "correct_voiced",
            "incorrect_voiced",
            "correct_unvoiced",
            "correct_pitches_strict",
            "correct_chromas_strict",
        )
        self.acc = {k: np.zeros(R, np.int64) for k in self._scalar_keys}
        self.acc.update({k: np.zeros((R, K), np.int64) for k in self._grid_keys})
        self.loss_sum = 0.0
        self.batch_count = 0

    @classmethod
    def validation_grid(cls, num_recs: int) -> "MelodyMetrics":
        """The 99-point threshold grid np.arange(.01, 1, .01)
        (dcnet/softmax_viterbi.py:1977-1980)."""
        t = np.arange(0.01, 1.0, 0.01, dtype=np.float64).astype(np.float32)
        return cls(num_recs=num_recs, thresholds=t)

    def update(self, rec_idx: int, counts: dict, loss: float | None = None):
        for k in self._scalar_keys:
            self.acc[k][rec_idx] += int(counts[k])
        for k in self._grid_keys:
            self.acc[k][rec_idx] += np.asarray(counts[k], np.int64)
        if loss is not None:
            self.loss_sum += float(loss)
        self.batch_count += 1

    def num_frames_vector(self) -> np.ndarray:
        return self.acc["voiced"] + self.acc["unvoiced"]

    def best_voicing_threshold(self) -> tuple[int, float]:
        """argmax over thresholds of mean per-rec voicing accuracy
        (MetricsValidation.best_voicing_threshold_fn, :2179-2207)."""
        va = _f8div(
            self.acc["correct_voiced"] + self.acc["correct_unvoiced"],
            self.num_frames_vector()[:, None],
        )
        idx = int(np.argmax(va.mean(axis=0)))
        return idx, float(self.thresholds[idx])

    def results(self, th_idx: int | None = None) -> dict:
        """Per-recording metric vectors [num_recs] + mean loss.

        th_idx defaults to the best threshold on the VA grid (or 0 when K=1).
        """
        if th_idx is None:
            th_idx = 0 if len(self.thresholds) == 1 else self.best_voicing_threshold()[0]
        a = self.acc
        nf = self.num_frames_vector()
        res = dict(
            vrr=_f8div(a["correct_voiced"][:, th_idx], a["voiced"]),
            vfa=_f8div(a["incorrect_voiced"][:, th_idx], a["unvoiced"]),
            va=_f8div(
                a["correct_voiced"][:, th_idx] + a["correct_unvoiced"][:, th_idx], nf
            ),
            rpa_strict=_f8div(a["correct_pitches_strict"][:, th_idx], a["voiced"]),
            rpa_wide=_f8div(a["correct_pitches_wide"], a["voiced"]),
            rca_strict=_f8div(a["correct_chromas_strict"][:, th_idx], a["voiced"]),
            rca_wide=_f8div(a["correct_chromas_wide"], a["voiced"]),
            oa=_f8div(
                a["correct_pitches_strict"][:, th_idx] + a["correct_unvoiced"][:, th_idx],
                nf,
            ),
        )
        if self.batch_count:
            res["loss"] = np.float32(self.loss_sum / self.batch_count)
        return res

    def mean_oa(self, th_idx: int | None = None) -> float:
        return float(np.mean(self.results(th_idx)["oa"]))
