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
GPU, their plain versions of the same dispatch on the CPU. With
`fused_obs`, the observation model is the fused kernel K5/K6
(hmm/obs_fused.py) on the whole batch instead. With a `mesh`
(dist/mesh.py), the decode splits the batch's tracks over the mesh's
"data" devices.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import tracing
from ..dist.mesh import Mesh
from ..hmm import obs_fused
from ..hmm.obs import shaun_observation_probs, softmax_observation_probs
from ..hmm.prepared import prepared_hmm
from ..hmm.viterbi_dense import viterbi_decode_batch, viterbi_decode_batch_logobs
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
    # serving fast path: the fused observation kernel (K5/K6,
    # hmm/obs_fused.py) on the whole batch, feeding the decoder directly.
    # Equal to the default path up to the softmax denominators' summation
    # order and ulp-level transcendentals (the kernels' tolerance contract);
    # opt-in.
    fused_obs: bool = False
    # where the observation model, the decode and the metrics run: CUDA
    # unless "cpu" is asked for (raises when CUDA is absent)
    device: object = None
    # optional dist.Mesh with a "data" axis: decode batches split tracks
    # across its devices (paths identical to one device). None = the
    # setup's device alone.
    mesh: object = None

    def __post_init__(self):
        if self.method not in ALLOWED_VITERBI_METHODS:
            raise ValueError(f"unknown viterbi method {self.method}")
        self.device = resolve_device(self.device)
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise ValueError(f"mesh must be a viterbi_spl_tpu_torch.dist.Mesh, got {type(self.mesh)}")
        # the decode's tables, host and card, built (and A and pi validated)
        # once; the decode paths hand them to the decode APIs
        self.hmm = prepared_hmm(self.transition_matrix, self.init_probs)
        if self.mesh is None:
            self.hmm.card(self.device)

    @classmethod
    def from_numpy(cls, fields: dict, device=None) -> "DecoderSetup":
        """A setup from the numpy/scalar fields of the JAX package's
        DecoderSetup (dataclasses.asdict), fused_obs and mesh included. The
        mesh must be the port's own (dist.make_mesh): a jax Mesh raises."""
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
        logits = tracing.upload(np.asarray(logits), self.device, "decode_service", torch.float32)
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
        same log observations. A `decode_service` span (tracing.py)."""
        with tracing.span("decode_service"):
            if self.fused_obs:
                return self._decode_batch_fused(logits_list)
            with tracing.span("decode_service.observe"):
                obs_list = [self.observation_probs(lg) for lg in logits_list]
            states_list = viterbi_decode_batch(
                transition_matrix=self.transition_matrix,
                prob_init=self.init_probs,
                probs_st_list=[o.T for o in obs_list],
                device=self.device,
                mesh=self.mesh,
                hmm=self.hmm,
            )
            out = []
            for states in states_list:
                voiced = states < self.n_bins
                bins = np.minimum(states, self.n_bins - 1)
                out.append((voiced, bins))
            return out

    def obs_config(self) -> dict:
        """The observation model as the fused kernels' obs dict
        (hmm/obs_fused.py::obs_params)."""
        return dict(method=self.method, spw=self.spw, threshold_logit=self.threshold_logit,
                    p=self.obs_p, scale=self.obs_scale, init_probs=self.init_probs)

    def _decode_batch_fused(self, logits_list: Sequence) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fused serving path: the batch staged on the host as one
        zero-filled [N, T_max, n_bins] array and copied to the device once,
        the fused observation kernel (K5/K6) on the whole batch, then the
        batched decode with the lengths (split over the mesh's data devices
        when there is one). (Frames past a track's length are zeros, which the
        decode never reads.) As in the JAX package, this path does not take
        the in-forward variant K9 (viterbi_decode_batch_fused_obs)."""
        lengths = [np.asarray(lg).shape[0] for lg in logits_list]
        staged = np.zeros((len(lengths), max(lengths), self.n_bins), np.float32)
        for i, lg in enumerate(logits_list):
            staged[i, : lengths[i]] = np.asarray(lg, np.float32)
        with tracing.span("decode_service.observe"):
            logits = tracing.upload(staged, self.device, "decode_service")
            log_obs = obs_fused.log_obs(logits, self.obs_config())
        states = viterbi_decode_batch_logobs(
            transition_matrix=self.transition_matrix, prob_init=self.init_probs,
            log_obs=log_obs, lengths=lengths, mesh=self.mesh, hmm=self.hmm,
        )
        states = tracing.to_host(states, "decode_service").numpy()
        out = []
        for i, L in enumerate(lengths):
            st = states[i, :L].astype(np.int64)
            out.append((st < self.n_bins, np.minimum(st, self.n_bins - 1)))
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
        # a tensor on the device (the raw path's peaks) or a NumPy array
        # (the decoded bins)
        bins_t = torch.as_tensor(bins_arr).to(dev, torch.int64)
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
