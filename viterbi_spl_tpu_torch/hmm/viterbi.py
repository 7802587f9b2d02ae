"""Log-domain Viterbi decoding in plain PyTorch (counterpart of
viterbi_spl_tpu/hmm/viterbi.py).

Same DP as the reference's canonical decoder (dcnet/tf_viterbi_decoding.py:
156-263): with A row-stochastic and B = log(A.T + tiny),

    T1[0]    = log pi + log b_0
    T1[t][s] = max_{s'} (T1[t-1][s'] + B[s, s']) + log b_t[s]
    T2[t][s] = argmax_{s'} (first-max tie-breaking, as np.argmax)

then a backward pointer chase from argmax T1[-1]. All tables are float32;
the tiny floor is float32 tiny, matching the reference exactly.

The host-side tables stay NumPy (`prepare_log_params`), so that every
decoder — the oracle, the JAX package and this port's kernels — consumes
bit-identical tables. The batched kernels and the decode dispatch live in
`viterbi_banded` and `viterbi_dense`.
"""

from __future__ import annotations

import numpy as np
import torch

TINY = np.float32(np.finfo(np.float32).tiny)

# Fill value for padded states: never wins an argmax against real states and
# does not overflow when accumulated across two adds (-1e30 + -1e30 = -2e30).
NEG_PAD = np.float32(-1e30)


def prepare_log_params(transition_matrix, prob_init, pad_to: int | None = None):
    """Host-side prep: (A, pi) -> (log(A.T)+tiny [S,S], log pi [S]) float32.

    Optionally pads the state dimension to `pad_to` with NEG_PAD rows/cols so
    padded states are unreachable. Computed with NumPy so every decoder
    consumes bit-identical tables.
    """
    A = np.asarray(transition_matrix, np.float32)
    pi = np.asarray(prob_init, np.float32)
    S = A.shape[0]
    if A.shape != (S, S) or pi.shape != (S,):
        raise ValueError(f"bad shapes A={A.shape} pi={pi.shape}")
    if not np.allclose(A.sum(axis=1), 1.0):
        raise ValueError("transition matrix rows must sum to 1")
    if not np.isclose(pi.sum(), 1.0):
        raise ValueError("prob_init must sum to 1")

    log_B = np.ascontiguousarray(np.log(A.T + TINY), dtype=np.float32)
    log_pi = np.log(pi + TINY).astype(np.float32)
    if pad_to is not None and pad_to > S:
        P = pad_to
        padded_B = np.full((P, P), NEG_PAD, np.float32)
        padded_B[:S, :S] = log_B
        padded_pi = np.full((P,), NEG_PAD, np.float32)
        padded_pi[:S] = log_pi
        log_B, log_pi = padded_B, padded_pi
    return log_B, log_pi


def log_obs_fn(probs_ts: torch.Tensor) -> torch.Tensor:
    """log(obs + tiny) — probs_ts is time-major [T, S] (or [..., T, S])."""
    return torch.log(probs_ts.to(torch.float32) + float(TINY))


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST maximum along `dim` (np.argmax semantics), as the
    minimum index among the entries equal to the max."""
    m = x.amax(dim=dim, keepdim=True)
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    idx = torch.arange(size, device=x.device).view(shape)
    return torch.where(x == m, idx, size).amin(dim=dim)


def viterbi_forward(log_B: torch.Tensor, log_pi: torch.Tensor, log_obs: torch.Tensor):
    """Forward DP over a batch: log_B [S, S], log_pi [S], log_obs [N, T, S].
    Returns (T1_last [N, S], T2 [N, T, S] int64); T2[:, 0] is zeros."""
    N, T, S = log_obs.shape
    t1 = log_pi[None, :] + log_obs[:, 0]
    T2 = torch.zeros((N, T, S), dtype=torch.int64, device=log_obs.device)
    for t in range(1, T):
        scores = t1[:, None, :] + log_B[None]  # [N, s, s']
        bp = first_argmax(scores, dim=2)
        T2[:, t] = bp
        t1 = torch.gather(scores, 2, bp[..., None])[..., 0] + log_obs[:, t]
    return t1, T2


def viterbi_backtrace(T2: torch.Tensor, last_states: torch.Tensor) -> torch.Tensor:
    """Pointer chase: states[T-1] = last; states[t] = T2[t+1][states[t+1]].
    T2 [N, T, S], last_states [N] -> states [N, T] int64."""
    N, T, _ = T2.shape
    states = torch.empty((N, T), dtype=torch.int64, device=T2.device)
    s = last_states.to(torch.int64)
    states[:, T - 1] = s
    for t in range(T - 2, -1, -1):
        s = torch.gather(T2[:, t + 1], 1, s[:, None])[:, 0]
        states[:, t] = s
    return states


def viterbi_decode_batch_plain(log_B, log_pi, log_obs_batch) -> torch.Tensor:
    """Batched decode of full-length tracks: log_obs_batch [N, T, S] ->
    states [N, T] int64 (tracks share log_B and log_pi)."""
    t1_last, T2 = viterbi_forward(log_B, log_pi, log_obs_batch)
    return viterbi_backtrace(T2, first_argmax(t1_last, dim=1))
