"""Evaluation: posteriorgrams -> dual-path metrics (raw threshold + Viterbi)
with the mir_eval cross-check (counterpart of
viterbi_spl_tpu/harness/evaluate.py).

Re-design of MetricsInference (dcnet/softmax_viterbi.py:2677-3230): for
each track, accumulate
- the RAW path: per-frame peak + voicing threshold,
- the VITERBI path: observation model -> HMM decode -> voicing from the
  decoded state,
and cross-check both accumulated OAs against the mir_eval-semantics
evaluation on signed frequencies (:3160-3198).

The observation model and the metrics run in PyTorch on the setup's device
(CUDA unless the caller asks for the CPU). Decoding always goes through the
batched decode API (hmm/viterbi_dense.py): the CUDA kernels K1-K4 on the
GPU, their plain versions of the same dispatch on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..hmm.obs import shaun_observation_probs, softmax_observation_probs
from ..hmm.viterbi import prepare_log_params
from ..hmm.viterbi_dense import viterbi_decode_batch
from ..metrics.mel_eval import est_notes_with_voicing_to_hz, evaluate_melody
from ..metrics.melody import (
    MelodyMetrics,
    est_notes_interp,
    frame_counts,
    frame_counts_fixed_voicing,
)
from ..utils import resolve_device

ALLOWED_VITERBI_METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")


@dataclasses.dataclass
class DecoderSetup:
    """Per-family decoding configuration."""

    transition_matrix: np.ndarray  # [S, S]
    init_probs: np.ndarray  # [S]
    n_bins: int
    note_min: float
    bins_per_semitone: float
    spw: int
    voicing_threshold: float  # probability
    hop_seconds: float
    method: str = "shaun"
    obs_p: float = 0.8
    obs_scale: float = 2.0
    # imm: the threshold is already in the logit/log-energy domain
    # (imm/thresholding.py:80, THRESHOLD = 2.442347)
    threshold_is_logit: bool = False
    # jdc maps decoded bins to notes directly, without the +/-1-bin
    # probability interpolation (jdc/viterbi_softmax.py:2443-2470)
    interp_est_notes: bool = True
    # where the observation model, the decode and the metrics run: CUDA
    # unless "cpu" is asked for (raises when CUDA is absent)
    device: object = None

    def __post_init__(self):
        if self.method not in ALLOWED_VITERBI_METHODS:
            raise ValueError(f"unknown viterbi method {self.method}")
        self.device = resolve_device(self.device)
        # validates A and pi; the decode API derives its tables the same way
        prepare_log_params(self.transition_matrix, self.init_probs)

    @classmethod
    def from_numpy(cls, fields: dict, device=None) -> "DecoderSetup":
        """A setup from the numpy/scalar fields of the JAX package's
        DecoderSetup (dataclasses.asdict minus fused_obs and mesh)."""
        return cls(**fields, device=device)

    @property
    def threshold_logit(self) -> float:
        if self.threshold_is_logit:
            return float(self.voicing_threshold)
        return float(np.log(self.voicing_threshold / (1 - self.voicing_threshold)))

    # -- observation model ------------------------------------------------
    def observation_probs(self, logits) -> torch.Tensor:
        """logits [T, n_bins] -> obs weights [T, n_bins + 1] (unvoiced last),
        on the setup's device."""
        logits = torch.as_tensor(np.asarray(logits), dtype=torch.float32).to(self.device)
        th_logit = self.threshold_logit
        if self.method == "shaun":
            return shaun_observation_probs(
                logits, th_logit, self.spw, self.obs_p, self.obs_scale
            )
        return softmax_observation_probs(
            logits, th_logit, self.init_probs, self.spw,
            scaled=self.method == "softmax-scaled",
        )

    def decode(self, logits) -> tuple[np.ndarray, np.ndarray]:
        """logits [T, n_bins] -> (voiced [T] bool, bins [T] int) — the
        Viterbi __call__ contract (dcnet/softmax_viterbi.py:2419-2432)."""
        return self.decode_batch([logits])[0]

    def decode_batch(self, logits_list: Sequence) -> list[tuple[np.ndarray, np.ndarray]]:
        """Decode many tracks together through the batched decode API
        (banded kernels when the transition structure allows, dense
        otherwise). Paths are bit-identical to the NumPy oracle given the
        same log observations."""
        obs_list = [self.observation_probs(lg) for lg in logits_list]
        states_list = viterbi_decode_batch(
            transition_matrix=self.transition_matrix,
            prob_init=self.init_probs,
            probs_st_list=[o.T for o in obs_list],
            device=self.device,
        )
        out = []
        for states in states_list:
            voiced = states < self.n_bins
            bins = np.minimum(states, self.n_bins - 1)
            out.append((voiced, bins))
        return out


def decode_and_score_track(
    setup: DecoderSetup,
    logits: np.ndarray,
    ref_notes: np.ndarray,
    original: dict | None = None,
    logits_are_probs: bool = False,
    voicing_logits: np.ndarray | None = None,
) -> dict:
    """One track through both metric paths.

    logits: [T, n_bins] (sigmoid logits for the raw path).
    voicing_logits: optional separate per-frame voicing logits (jdc) — the
    raw path's voicing decision compares them to the threshold logit
    instead of the peak probability.
    Returns dict with raw/viterbi count dicts, est note vectors, and (when
    `original` ref times/freqs are given) the mir_eval OAs.
    """
    T, n_bins = logits.shape
    dev = setup.device
    f32 = torch.float32
    logits_t = torch.as_tensor(np.asarray(logits), dtype=f32).to(dev)
    probs = logits_t if logits_are_probs else torch.sigmoid(logits_t)
    ref_t = torch.as_tensor(np.asarray(ref_notes), dtype=f32).to(dev)

    def notes_from_bins(bins_arr):
        bins_t = torch.as_tensor(np.asarray(bins_arr)).to(dev, torch.int64)
        if setup.interp_est_notes:
            return est_notes_interp(
                bins_t, probs, setup.note_min, setup.bins_per_semitone, n_bins
            )
        grid = (
            torch.arange(n_bins, dtype=f32, device=dev) / setup.bins_per_semitone
            + setup.note_min
        )
        return grid[torch.clamp(bins_t, max=n_bins - 1)]

    # raw path (torch.argmax returns the first maximum, as np.argmax)
    peak_idx = torch.argmax(probs, dim=1)
    peak_probs = torch.gather(probs, 1, peak_idx[:, None])[:, 0]
    est_notes_raw = notes_from_bins(peak_idx)
    if voicing_logits is not None:
        voicing_score = torch.as_tensor(np.asarray(voicing_logits), dtype=f32).to(dev)
        th = torch.tensor(setup.threshold_logit, dtype=f32, device=dev)
    elif setup.threshold_is_logit:
        voicing_score = logits_t.amax(dim=1)
        th = torch.tensor(setup.voicing_threshold, dtype=f32, device=dev)
    else:
        voicing_score = peak_probs
        th = torch.tensor(setup.voicing_threshold, dtype=f32, device=dev)
    raw_counts = frame_counts(ref_t, est_notes_raw, voicing_score, th[None])
    raw_voicing = (voicing_score > th).cpu().numpy()

    # viterbi path
    voiced, bins = setup.decode(np.asarray(logits))
    est_notes_vit = notes_from_bins(bins)
    vit_counts = frame_counts_fixed_voicing(ref_t, est_notes_vit, voiced)

    out = dict(
        raw_counts={k: v.cpu().numpy() for k, v in raw_counts.items()},
        viterbi_counts={k: v.cpu().numpy() for k, v in vit_counts.items()},
        est_notes_raw=est_notes_raw.cpu().numpy(),
        est_notes_viterbi=est_notes_vit.cpu().numpy(),
        viterbi_voiced=voiced,
        viterbi_bins=bins,
        raw_voiced=raw_voicing,
    )

    if original is not None:
        est_times = np.arange(T) * setup.hop_seconds
        for key, notes, voicing in (
            ("raw", out["est_notes_raw"], raw_voicing),
            ("viterbi", out["est_notes_viterbi"], voiced),
        ):
            signed = np.where(voicing, notes, -notes)
            freqs = est_notes_with_voicing_to_hz(signed, min_note=setup.note_min)
            m = evaluate_melody(
                original["times"], original["freqs"], est_times, freqs
            )
            out[f"mir_eval_oa_{key}"] = m["Overall Accuracy"]
    return out


def evaluate_posteriorgrams(
    setup: DecoderSetup,
    tracks: Sequence[dict],
) -> dict:
    """Full-split evaluation: tracks is a list of dicts with keys
    logits [T, n_bins], notes [T], and optionally original{times, freqs}.

    Returns dict(raw=<metrics>, viterbi=<metrics>, mir_eval_oas=...,
    cross_check_diffs=...) — the accumulated OA must match the mir_eval OA
    per track (the reference prints these diffs, :3504-3531).
    """
    n = len(tracks)
    raw = MelodyMetrics(n, np.array([setup.voicing_threshold], np.float32))
    vit = MelodyMetrics(n, np.array([0.5], np.float32))
    oas_raw, oas_vit = [], []
    for rec_idx, track in enumerate(tracks):
        r = decode_and_score_track(
            setup,
            track["logits"],
            track["notes"],
            original=track.get("original"),
            logits_are_probs=track.get("logits_are_probs", False),
            voicing_logits=track.get("voicing_logits"),
        )
        raw.update(rec_idx, r["raw_counts"])
        vit.update(rec_idx, r["viterbi_counts"])
        oas_raw.append(r.get("mir_eval_oa_raw"))
        oas_vit.append(r.get("mir_eval_oa_viterbi"))

    res_raw = raw.results(0)
    res_vit = vit.results(0)
    out = dict(
        raw=res_raw,
        viterbi=res_vit,
        raw_mean_oa=float(np.mean(res_raw["oa"])),
        viterbi_mean_oa=float(np.mean(res_vit["oa"])),
        mir_eval_oas_raw=oas_raw,
        mir_eval_oas_viterbi=oas_vit,
    )
    if oas_raw[0] is not None:
        out["cross_check_diff_raw"] = [
            float(a - b) for a, b in zip(res_raw["oa"], oas_raw)
        ]
        out["cross_check_diff_viterbi"] = [
            float(a - b) for a, b in zip(res_vit["oa"], oas_vit)
        ]
    return out
