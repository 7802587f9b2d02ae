"""Offline HMM-parameter pipeline: validation statistics -> .dat artifacts
(counterpart of viterbi_spl_tpu/cli/hmm_artifacts.py, minus its `main`,
which needs the label pipeline of a later slice).

Runnable equivalent of the reference's three-stage offline pipeline
(SURVEY.md §3.5):
  (1) */viterbi_ini_probs_and_transition.py — count stats,
  (2) */viterbi_transition_post_processing.py — shape the transition matrix,
  (3) */p_steady_post_processing.py — shape the init probs,
writing the same artifact files in the same bitwise-compatible format:
  transition_int.dat, p_steady.dat, switch.dat,
  viterbi_transition_matrix.dat, viterbi_init_probs.dat.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..families import FamilySpec
from ..hmm import params as P
from ..io import load_array, save_array


def build_hmm_artifacts(
    quantized_tracks: list[np.ndarray],
    spec: FamilySpec,
    out_dir: str | os.PathLike,
    switch_override: np.ndarray | None = None,
    p_th: float | None = None,
) -> dict:
    """Counting + shaping for one family; writes the 5 .dat artifacts and
    returns dict(transition_matrix, init_probs, stats)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_bins = spec.n_bins
    if spec.d_max is None:
        raise ValueError("analytic-transition family (imm) has no counting stage")

    stats = P.count_statistics(quantized_tracks, n_bins)
    save_array(out / "transition_int.dat", stats.transition_counts, "transition_int")
    save_array(out / "p_steady.dat", stats.p_steady, "p_steady")
    save_array(out / "switch.dat", stats.switch, "switch")

    switch = stats.switch if switch_override is None else switch_override
    A = P.shape_transition_matrix(
        stats.transition_counts, switch, n_bins, spec.d_max, spec.floor
    )
    save_array(
        out / "viterbi_transition_matrix.dat", A, "viterbi_transition_matrix"
    )

    if p_th is None and spec.name == "dcnet":
        p_th = 3e-4  # dcnet/viterbi_init_probs.py:11
    pi = P.shape_init_probs(stats.p_steady, p_th=p_th)
    save_array(out / "viterbi_init_probs.dat", pi, "viterbi_init_probs")

    return dict(transition_matrix=A, init_probs=pi, stats=stats)


def load_hmm_artifacts(artifact_dir: str | os.PathLike) -> dict:
    """Load viterbi_transition_matrix.dat + viterbi_init_probs.dat (with the
    reference's name/stochasticity asserts, dcnet/softmax_viterbi.py:
    2375-2417)."""
    d = Path(artifact_dir)
    name, A = load_array(d / "viterbi_transition_matrix.dat")
    if name != "viterbi_transition_matrix":
        raise ValueError(f"unexpected record name {name}")
    if not np.allclose(A.sum(axis=1), 1.0):
        raise ValueError("transition matrix is not row-stochastic")
    name, pi = load_array(d / "viterbi_init_probs.dat")
    if name != "viterbi_init_probs":
        raise ValueError(f"unexpected record name {name}")
    if not np.isclose(pi.sum(), 1.0) or not np.all(pi > 0):
        raise ValueError("bad init probs")
    return dict(transition_matrix=A, init_probs=pi)


def quantize_tracks_for_family(
    note_tracks: list[np.ndarray], spec: FamilySpec
) -> list[np.ndarray]:
    """MIDI note tracks -> per-family quantized bin tracks for counting."""
    note_max = float(spec.note_range[-1])
    return [
        P.quantize_ref_notes(
            notes, spec.note_min, note_max, spec.bins_per_semitone, spec.n_bins
        )
        for notes in note_tracks
    ]
