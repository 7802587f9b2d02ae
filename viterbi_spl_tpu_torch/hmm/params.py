"""HMM parameter estimation: validation-split statistics -> decoding params.

Re-design of the reference's offline parameter pipeline (SURVEY.md §2.4):

  1. count_statistics — quantize reference notes to pitch bins, count
     steady-state occupancy, bin-to-bin transitions and voiced/unvoiced
     switches over consecutive frames
     (dcnet/softmax_viterbi.py:744-812, jdc/viterbi_ini_probs_and_transition.py:188-244).
  2. shape_transition_matrix — pool transition counts by pitch distance
     clipped to ±d_max, floor, normalize into a banded Toeplitz voiced block,
     couple with the voiced/unvoiced switch matrix
     (dcnet/viterbi_transition_matrix.py:62-101, ftanet/viterbi_transition_post_processing.py:10-89).
  3. shape_init_probs — floor steady-state probs and renormalize the voiced
     mass (dcnet/viterbi_init_probs.py:111-140, */p_steady_post_processing.py).
  4. imm_transition_matrix — Durrieu's analytic exponential-decay transition
     (imm/transition_matrix.py:4-41).

Everything is vectorized NumPy (this is one-time offline prep, not a hot
path); results are float32/float64 row-stochastic matrices ready for
`viterbi.prepare_log_params` and are serializable with io.array_file in the
reference's artifact format.

A NumPy copy of viterbi_spl_tpu/hmm/params.py: the port builds bitwise the
same matrices without importing the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def single_side_d_max(h_seconds: float, bins_per_oct: int) -> int:
    """Max per-hop pitch jump (in bins) from the 35.92 oct/s pitch-speed
    bound: d_max = 35.92 * h * B * 1.3 // 2
    (ftanet/viterbi_transition_post_processing.py:10-16)."""
    return int(35.92 * h_seconds * bins_per_oct * 1.3 // 2)


def quantize_ref_notes(
    ref_notes: np.ndarray,
    min_note: float,
    max_note: float,
    bins_per_semitone: float,
    n_bins: int,
) -> np.ndarray:
    """MIDI notes -> pitch-bin indices; unvoiced (note <= 0-ish) -> n_bins.

    bins = round((note - min_note) * bins_per_semitone); values below 0
    (i.e. unvoiced frames, note == 0) map to the unvoiced state n_bins.
    Notes are clamped to max_note first. Reference:
    dcnet/softmax_viterbi.py:744-758 (bins_per_semitone = 5 for 60 bins/oct).
    """
    notes = np.minimum(np.asarray(ref_notes, np.float64), max_note)
    bins = np.round((notes - min_note) * bins_per_semitone).astype(np.int32)
    bins[bins < 0] = n_bins
    if bins.max() > n_bins:
        raise ValueError("quantized bin above n_bins despite clamping")
    return bins


@dataclasses.dataclass
class HMMStatistics:
    """Raw counts accumulated over a split. All int64 except p_steady."""

    p_steady: np.ndarray  # [n_bins+1] float64, normalized occupancy
    steady_counts: np.ndarray  # [n_bins+1] int64
    transition_counts: np.ndarray  # [n_bins+1, n_bins+1] int64
    switch: np.ndarray  # [2, 2] float64, row-normalized switch probs
    switch_counts: np.ndarray  # [2, 2] int64


def count_statistics(quantized_tracks: list[np.ndarray], n_bins: int) -> HMMStatistics:
    """Accumulate occupancy/transition/switch counts over tracks.

    Matches the reference loop semantics exactly (dcnet/softmax_viterbi.py:
    770-786): occupancy counts every frame once; transitions and switches
    count consecutive pairs within each track (no cross-track pairs).
    """
    S = n_bins + 1
    steady = np.zeros(S, np.int64)
    trans = np.zeros((S, S), np.int64)
    switch = np.zeros((2, 2), np.int64)
    for q in quantized_tracks:
        q = np.asarray(q, np.int64)
        if q.ndim != 1 or len(q) < 2:
            raise ValueError("each track needs >= 2 frames")
        steady += np.bincount(q, minlength=S)
        np.add.at(trans, (q[:-1], q[1:]), 1)
        uv = (q == n_bins).astype(np.int64)
        np.add.at(switch, (uv[:-1], uv[1:]), 1)
    p_steady = steady / steady.sum()
    switch_probs = switch / np.maximum(switch.sum(axis=1, keepdims=True), 1)
    return HMMStatistics(
        p_steady=p_steady,
        steady_counts=steady,
        transition_counts=trans,
        switch=switch_probs,
        switch_counts=switch,
    )


def pool_transition_counts_by_distance(
    transition_counts: np.ndarray, n_bins: int, d_max: int, floor: int
) -> np.ndarray:
    """Pool voiced-block transition counts by pitch distance d = j - i clipped
    to ±d_max, then floor and normalize -> d_trans [2*d_max+1] float64.
    (dcnet/viterbi_transition_matrix.py:62-75, floor=6; ftanet variant floor=2.)
    """
    counts = np.asarray(transition_counts)[:n_bins, :n_bins]
    i = np.arange(n_bins)[:, None]
    j = np.arange(n_bins)[None, :]
    d = np.clip(j - i, -d_max, d_max) + d_max
    d_trans = np.zeros(2 * d_max + 1, np.int64)
    np.add.at(d_trans, d.ravel(), counts.ravel())
    d_trans = np.maximum(d_trans, floor)
    return d_trans / d_trans.sum()


def shape_transition_matrix(
    transition_counts: np.ndarray,
    switch: np.ndarray,
    n_bins: int,
    d_max: int,
    floor: int,
) -> np.ndarray:
    """Counts -> dense row-stochastic [n_bins+1, n_bins+1] transition matrix.

    Voiced block: banded Toeplitz from the distance-pooled distribution,
    row-normalized, scaled by switch[0,0]. Voiced->unvoiced = switch[0,1];
    unvoiced->voiced = switch[1,0]/n_bins uniformly; unvoiced->unvoiced =
    switch[1,1]. (dcnet/viterbi_transition_matrix.py:77-101.)
    """
    switch = np.asarray(switch, np.float64)
    if switch.shape != (2, 2) or not np.allclose(switch.sum(axis=1), 1.0):
        raise ValueError("switch must be 2x2 row-stochastic")
    d_trans = pool_transition_counts_by_distance(
        transition_counts, n_bins, d_max, floor
    )

    i = np.arange(n_bins)[:, None]
    j = np.arange(n_bins)[None, :]
    d = j - i
    in_band = np.abs(d) <= d_max
    voiced = np.where(in_band, d_trans[np.clip(d, -d_max, d_max) + d_max], 0.0)
    voiced = voiced / voiced.sum(axis=1, keepdims=True)

    A = np.zeros((n_bins + 1, n_bins + 1), np.float64)
    A[:n_bins, :n_bins] = voiced * switch[0, 0]
    A[:n_bins, n_bins] = switch[0, 1]
    A[n_bins, :n_bins] = switch[1, 0] / n_bins
    A[n_bins, n_bins] = switch[1, 1]
    if not np.allclose(A.sum(axis=1), 1.0):
        raise AssertionError("shaped transition matrix is not row-stochastic")
    return A.astype(np.float32)


def shape_init_probs(p_steady: np.ndarray, p_th: float | None = None) -> np.ndarray:
    """Steady-state occupancy -> initial distribution.

    Floors voiced-bin probs at p_th (default 1/len/10, the non-dcnet rule;
    dcnet uses 3e-4), renormalizes voiced mass to 1 - p_unvoiced, keeps
    p_unvoiced as counted. (dcnet/viterbi_init_probs.py:9-24.)
    """
    p_steady = np.asarray(p_steady, np.float64)
    if not np.isclose(p_steady.sum(), 1.0):
        raise ValueError("p_steady must sum to 1")
    if p_th is None:
        p_th = 1.0 / len(p_steady) / 10.0
    p_unvoiced = p_steady[-1]
    p_voiced = 1.0 - p_unvoiced
    ps = np.maximum(p_steady[:-1], p_th)
    ps = ps / ps.sum() * p_voiced
    out = np.append(ps, p_unvoiced).astype(np.float32)
    if not np.isclose(out.sum(), 1.0):
        raise AssertionError("init probs do not sum to 1")
    return out


def imm_transition_matrix(bins_per_semitone: int, n_bins: int) -> np.ndarray:
    """Durrieu's analytic IMM transition matrix (imm/transition_matrix.py:4-41).

    exp(-semitone distance) decay, flat beyond a 10-semitone cutoff, with
    vanishing voiced<->unvoiced couplings (10^-80..-100), row-normalized.
    """
    dist = np.arange(n_bins) // bins_per_semitone
    probs = np.exp(-dist).astype(np.float64)
    cutoff = 10 * bins_per_semitone
    probs[cutoff:] = probs[cutoff - 1]

    r = np.arange(n_bins)
    D = np.abs(r[:, None] - r[None, :])
    A = np.empty((n_bins + 1, n_bins + 1), np.float64)
    A[:n_bins, :n_bins] = probs[D]
    cp = probs[cutoff - 1]
    A[:n_bins, n_bins] = cp * 10.0**-90  # voiced -> unvoiced
    A[n_bins, :n_bins] = cp * 10.0**-80  # unvoiced -> voiced
    A[n_bins, n_bins] = cp * 10.0**-100
    A /= A.sum(axis=1, keepdims=True)
    if not np.allclose(A.sum(axis=1), 1.0):
        raise AssertionError("imm transition matrix not row-stochastic")
    return A
