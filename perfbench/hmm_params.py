"""The decode's transition matrix and initial probabilities, made from the
seed with a frozen copy of the melody families' shaping rule (the papers'
offline HMM pipeline, as the program's hmm/params.py has it): a seeded note
walk is counted, transitions are pooled by pitch distance clipped to
+-d_max and floored, the banded voiced block is row-normalized and coupled
to the unvoiced state by the switch matrix (counted from the walk, or the
configuration's fixed one), and the steady-state occupancy, floored at
1 / S / 10, gives the initial probabilities. Both sides get these arrays.
"""

from __future__ import annotations

import numpy as np

from .traffic import sub_seed


def note_walk(n_bins: int, frames: int, seed: int) -> np.ndarray:
    """Quantized states of a seeded walk: steps of -3..3 bins, voiced in
    runs of 20 frames (three in four), n_bins when unvoiced."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    walk = np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, frames)), 0, n_bins - 1)
    voiced = np.repeat(rng.random(frames // 20 + 1) < 0.75, 20)[:frames]
    return np.where(voiced, walk, n_bins).astype(np.int64)


def shaped_hmm(n_bins: int, d_max: int, floor: int, switch, seed: int, frames: int = 20000):
    """(A [S, S] float32, pi [S] float32), S = n_bins + 1."""
    q = note_walk(n_bins, frames, seed)
    S = n_bins + 1
    steady = np.bincount(q, minlength=S)
    trans = np.zeros((S, S), np.int64)
    np.add.at(trans, (q[:-1], q[1:]), 1)
    if switch is None:
        uv = (q == n_bins).astype(np.int64)
        sw = np.zeros((2, 2), np.int64)
        np.add.at(sw, (uv[:-1], uv[1:]), 1)
        switch = sw / np.maximum(sw.sum(axis=1, keepdims=True), 1)
    switch = np.asarray(switch, np.float64)

    i = np.arange(n_bins)[:, None]
    j = np.arange(n_bins)[None, :]
    d = np.clip(j - i, -d_max, d_max) + d_max
    d_trans = np.zeros(2 * d_max + 1, np.int64)
    np.add.at(d_trans, d.ravel(), trans[:n_bins, :n_bins].ravel())
    d_trans = np.maximum(d_trans, floor)
    d_trans = d_trans / d_trans.sum()
    in_band = np.abs(j - i) <= d_max
    voiced = np.where(in_band, d_trans[d], 0.0)
    voiced = voiced / voiced.sum(axis=1, keepdims=True)
    A = np.zeros((S, S), np.float64)
    A[:n_bins, :n_bins] = voiced * switch[0, 0]
    A[:n_bins, n_bins] = switch[0, 1]
    A[n_bins, :n_bins] = switch[1, 0] / n_bins
    A[n_bins, n_bins] = switch[1, 1]

    p = steady / steady.sum()
    ps = np.maximum(p[:-1], 1.0 / S / 10.0)
    ps = ps / ps.sum() * (1.0 - p[-1])
    return A.astype(np.float32), np.append(ps, p[-1]).astype(np.float32)
