"""NumPy oracle Viterbi decoder — the correctness reference for every
accelerated implementation in this package (a copy of
viterbi_spl_tpu/hmm/oracle.py, kept here so the port imports nothing of the
JAX package).

Reproduces the exact semantics of the canonical decoder that the reference
embeds in every family script (dcnet/tf_viterbi_decoding.py:156-263, copies
at e.g. dcnet/softmax_viterbi.py:2434-2485, msnet/hsieh_m2m3.py:1665-1717):

  log-domain max-plus DP with the transition matrix stored transposed
  (B = log(A.T + tiny)) so the inner step is a row-broadcast add followed by
  a row argmax; NumPy argmax first-max tie-breaking; float32 tables; tiny
  floor = float32 tiny (1.1754944e-38); backward pointer chase from
  argmax T1[-1].

The CUDA kernels are required (and tested) to produce bit-identical state
paths, mirroring the reference's own cross-implementation equality assert
(tf_viterbi_decoding.py:284). `viterbi_oracle_log` runs the same DP on
log tables directly, for checks whose inputs are already log observations.
"""

from __future__ import annotations

import numpy as np


def _validate(transition_matrix, prob_init, probs_st):
    B = np.asarray(transition_matrix)
    probs = np.asarray(probs_st)
    prob_init = np.asarray(prob_init)
    S = len(B)
    T = probs.shape[1]
    if B.shape != (S, S):
        raise ValueError(f"transition matrix must be square, got {B.shape}")
    if probs.shape != (S, T):
        raise ValueError(f"probs_st must be [S={S}, T], got {probs.shape}")
    if prob_init.shape != (S,):
        raise ValueError(f"prob_init must be [S={S}], got {prob_init.shape}")
    if not np.allclose(B.sum(axis=1), 1.0):
        raise ValueError("transition matrix rows must sum to 1")
    if not np.isclose(prob_init.sum(), 1.0):
        raise ValueError("prob_init must sum to 1")
    return B, prob_init, probs, S, T


def _log_tables(transition_matrix, prob_init, probs_st):
    B, prob_init, probs, S, T = _validate(transition_matrix, prob_init, probs_st)
    tiny = np.finfo(np.float32).tiny
    log_B = np.ascontiguousarray(np.log(B.T.astype(np.float32) + tiny))  # [s, s']
    log_init = np.log(prob_init.astype(np.float32) + tiny)
    log_obs = np.ascontiguousarray(np.log(probs.T.astype(np.float32) + tiny))  # [T, S]
    return log_B, log_init, log_obs


def _forward(log_B, log_init, log_obs):
    T, S = log_obs.shape
    T1 = np.empty([T, S], np.float32)
    T2 = np.zeros([T, S], np.int64)
    T1[0] = log_init + log_obs[0]
    scores = np.empty([S, S], np.float32)
    for t in range(1, T):
        np.add(T1[t - 1], log_B, out=scores)  # scores[s, s'] = T1[t-1, s'] + log A[s', s]
        np.argmax(scores, axis=1, out=T2[t])
        np.add(
            np.take_along_axis(scores, T2[t][:, None], axis=1)[:, 0],
            log_obs[t],
            out=T1[t],
        )
    return T1, T2


def viterbi_oracle_log(log_B, log_init, log_obs) -> np.ndarray:
    """Decode from float32 log tables: log_B [S, S] (= log(A.T + tiny)),
    log_init [S], log_obs [T, S] time-major. Returns [T] int64 states."""
    log_B = np.ascontiguousarray(log_B, np.float32)
    log_init = np.asarray(log_init, np.float32)
    log_obs = np.ascontiguousarray(log_obs, np.float32)
    T1, T2 = _forward(log_B, log_init, log_obs)
    T = log_obs.shape[0]
    states = np.empty([T], np.int64)
    s = int(np.argmax(T1[-1]))
    states[-1] = s
    for t in range(T - 2, -1, -1):
        s = T2[t + 1, s]
        states[t] = s
    return states


def viterbi_oracle(*, transition_matrix, prob_init, probs_st) -> np.ndarray:
    """Decode the MAP state path.

    Args:
      transition_matrix: [S, S] row-stochastic A, A[s, s'] = P(s' | s).
      prob_init: [S] initial state distribution.
      probs_st: [S, T] observation probabilities P(obs_t | state s).

    Returns:
      [T] int64 state indices.
    """
    return viterbi_oracle_log(*_log_tables(transition_matrix, prob_init, probs_st))


def viterbi_oracle_forward(*, transition_matrix, prob_init, probs_st):
    """Forward pass only: returns (T1 [T,S] float32, T2 [T,S] int64).

    Used by tests to check accelerated forward tables element-wise.
    """
    return _forward(*_log_tables(transition_matrix, prob_init, probs_st))
