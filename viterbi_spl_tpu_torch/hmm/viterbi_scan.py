"""Exact parallel-scan Viterbi: an inclusive max-plus matrix scan
(counterpart of viterbi_spl_tpu/hmm/viterbi_scan.py).

The forward recursion is a scan over max-plus matrix-vector products; it
parallelizes without halos or convergence assumptions by lifting each frame
to the max-plus matrix

    M_t[i, j] = log A[i, j] + log b_t[j]

and composing with the associative max-plus product
(M1 (x) M2)[i, j] = max_k M1[i, k] + M2[k, j]. The prefix products P_t
give T1[t] = max_i (log pi_0[i] + P_t[i, :]) for all t in O(log T) steps
(here a Hillis-Steele scan: step d composes every prefix with the one d
frames before it).

The JAX module has no Pallas kernel, and this one is plain PyTorch. A
composition materializes [.., S, S, S] sums, so the products are composed
in chunks of at most CHUNK_ELEMS sums. Max-plus composition is exact in
the maxima but not in the adds: float32 addition is not associative, and
the scan adds in another order than the sequential recursion (and than
jax.lax.associative_scan), so T1 agrees with both to a tolerance, not to
the ulp. The backpointers are reconstructed per frame as in the kernel
backtraces (first-argmax of T1[t] + log B[s_{t+1}]).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .viterbi import first_argmax, log_obs_fn, prepare_log_params

# sums [k, S, S, S] materialized per composition chunk
CHUNK_ELEMS = 1 << 24


def _maxplus_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[K, S, S] (x) [K, S, S] max-plus matrix products, chunked over K."""
    K, S, _ = a.shape
    step = max(1, CHUNK_ELEMS // (S * S * S))
    out = torch.empty_like(a)
    for k in range(0, K, step):
        out[k:k + step] = (a[k:k + step, :, :, None] + b[k:k + step, None, :, :]).amax(dim=2)
    return out


def viterbi_t1_scan(log_A: torch.Tensor, log_pi: torch.Tensor, log_obs: torch.Tensor) -> torch.Tensor:
    """All T1 rows via an inclusive max-plus scan. log_A [S, S] (= log A,
    NOT transposed), log_pi [S], log_obs [T, S]. Returns T1 [T, S] f32."""
    T, S = log_obs.shape
    t1_0 = (log_pi + log_obs[0])[None, :]
    if T == 1:
        return t1_0
    P = log_A[None, :, :] + log_obs[1:, None, :]  # M_t for t >= 1, [T-1, S, S]
    d = 1
    while d < T - 1:
        P = torch.cat([P[:d], _maxplus_compose(P[:-d], P[d:])])
        d *= 2
    t1_rest = (t1_0[0][None, :, None] + P).amax(dim=1)
    return torch.cat([t1_0, t1_rest])


def _backtrace_from_t1(log_B: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Reverse chase reconstructing backpointers from T1 rows (first-argmax):
    log_B [S, S] = log A.T. Returns states [T] int64."""
    T = t1.shape[0]
    states = torch.empty(T, dtype=torch.int64, device=t1.device)
    s = torch.argmax(t1[-1])
    states[-1] = s
    for t in range(T - 2, -1, -1):
        s = first_argmax(t1[t] + log_B[s])
        states[t] = s
    return states


def viterbi_decode_scan(*, transition_matrix, prob_init, probs_st, device=None) -> np.ndarray:
    """Oracle-signature decode through the scan: probs_st [S, T] -> [T]
    int64 states."""
    dev = resolve_device(device)
    log_B, log_pi = prepare_log_params(transition_matrix, prob_init)
    log_B = torch.from_numpy(log_B).to(dev)
    log_obs = log_obs_fn(torch.as_tensor(np.asarray(probs_st, np.float32)).to(dev).T)
    t1 = viterbi_t1_scan(log_B.T.contiguous(), torch.from_numpy(log_pi).to(dev), log_obs)
    return _backtrace_from_t1(log_B, t1).cpu().numpy()
