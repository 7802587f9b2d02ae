"""Seam-certificate stress fixture for the sequence-parallel decoder (a
NumPy copy of viterbi_spl_tpu/dist/certify.py, whose arrays it reproduces
bit for bit).

`make_seam_stress_hmm` constructs an HMM + observation track on which the
time-sharded decode's seam certificate FAILS for small halos and passes
once the halo covers the ambiguity: a deterministic way to exercise the
auto-halo doubling loop (`viterbi_decode_time_sharded`) end to end.

Construction (states 0 and 1 of S, switching cost log ~0.01):
  - frames [0, seam-hw) pin state 0, frames [seam+hw, T) pin state 1,
  - the ambiguous stretch [seam-hw, seam+hw) carries a tiny per-frame
    margin toward 0, EXCEPT one mid-strength nudge toward 1 at
    `seam - hw + 6`; the nudge (not the margins) determines where the
    optimal path pays its single 0->1 switch.
  Blocks left of the seam only see the nudge once their window
  [block*L - H, (block+1)*L + H) reaches past seam+hw, and the block
  right of the seam only sees it once H >= hw + (hw - 6); with hw = 32
  and L = 128 the seam certificate fails at halos 16 and 32 and first
  passes at 64, so an auto-halo run starting at 16 performs two doubling
  episodes and returns 64.
"""

from __future__ import annotations

import numpy as np


def make_seam_stress_hmm(n_blocks: int, L: int = 128, S: int = 8, hw: int = 32):
    """Returns (A [S,S] f32, pi [S], obs [T,S] f32, expected switch frame).
    T = n_blocks * L; the stressed seam is the start of block
    min(3, n_blocks-1)."""
    if n_blocks < 2:
        raise ValueError("need at least 2 time blocks to have a seam")
    T = n_blocks * L
    seam = min(3, n_blocks - 1) * L
    A = np.full((S, S), 1e-3, np.float32)
    np.fill_diagonal(A, 1.0)
    A[0, 1] = A[1, 0] = 0.01
    A = A / A.sum(1, keepdims=True)
    pi = np.full(S, 1.0 / S, np.float32)
    obs = np.full((T, S), 1e-3, np.float32)
    lo, hi = seam - hw, seam + hw
    obs[:lo, 0] = 0.9
    obs[hi:, 1] = 0.9
    obs[lo:hi, 0] = 0.1 * 1.0001  # tiny margin toward 0 (breaks ties)
    obs[lo:hi, 1] = 0.1
    switch = lo + 6
    obs[switch, 1] = 0.11  # the switch-placing nudge
    obs = obs / obs.sum(1, keepdims=True)
    return A, pi, obs.astype(np.float32), switch
