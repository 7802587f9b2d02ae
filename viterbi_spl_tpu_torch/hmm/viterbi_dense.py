"""Dense batched Viterbi kernels and the batched decode API (counterpart of
the `_batch` half of viterbi_spl_tpu/hmm/viterbi_pallas.py).

K3 (forward) and K4 (backtrace) are CUDA C++ in csrc/viterbi_dense.cu,
each with its plain PyTorch version here. The forward stores no
backpointers: it writes the shifted rows t1m1[:, t] = T1[t-1] (row 0
zeros), and the backtrace rebuilds each pointer as the first-max argmax of
t1m1[t] + logB[s_t, :] — the very row the forward step reduced, so paths
are bit-identical to storing backpointers, and to the NumPy oracle.

`viterbi_decode_batch_logobs` keeps the dispatch of the JAX package's
`viterbi_decode_batch_pallas_logobs`: the banded forward (K1) when the
transition matrix has the shaped melody structure, else the dense forward
(K3); the first-max argmax of t1_last; the banded backtrace (K2) when the
structure carries source-profile classes, else the dense backtrace (K4).
PyTorch runs eagerly, so there is no shape bucketing and no padding of N
or S.

`viterbi_decode_batch_fused_obs` is the serving path from raw logits: the
forward with the observation model inside it (K9) when the structure is
banded, else the observation kernel (K5/K6) and the dense decode.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib
from ..utils import resolve_device
from . import obs_fused
from .viterbi import first_argmax, log_obs_fn, prepare_log_params
from .viterbi_banded import (
    banded_backtrace,
    banded_forward,
    banded_forward_obs,
    extract_banded_structure,
)


def dense_forward_plain(log_B, log_pi, log_obs, lengths):
    """K3's plain version: log_B [S, S] (= log(A.T + tiny)), log_pi [S],
    log_obs [N, T, S], lengths [N] -> (t1_last [N, S], t1m1 [N, T, S])."""
    N, T, S = log_obs.shape
    dev = log_obs.device
    lengths = torch.as_tensor(lengths, device=dev)
    log_B = log_B.to(dev)
    prev = log_pi.to(dev)[None, :] + log_obs[:, 0]
    t1m1 = torch.zeros_like(log_obs)
    for t in range(1, T):
        t1m1[:, t] = prev
        m = (prev[:, None, :] + log_B[None]).amax(dim=2)  # [N, s]
        prev = torch.where((t < lengths)[:, None], m + log_obs[:, t], prev)
    return prev, t1m1


def dense_backtrace_plain(log_B, t1m1, last_states, lengths):
    """K4's plain version -> states [N, T] int32 (zeros at or beyond each
    track's length)."""
    N, T, S = t1m1.shape
    dev = t1m1.device
    log_B = log_B.to(dev)
    lengths = torch.as_tensor(lengths, device=dev)
    last = torch.as_tensor(last_states, device=dev).to(torch.int64)
    states = torch.zeros((N, T), dtype=torch.int32, device=dev)
    s = last.clone()
    for t in range(T - 1, -1, -1):
        s = torch.where(t == lengths - 1, last, s)
        active = t < lengths
        states[:, t] = torch.where(active, s, 0).to(torch.int32)
        bp = first_argmax(t1m1[:, t] + log_B[s], dim=1)
        s = torch.where(active, bp, s)
    return states


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vspl_dense_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vspl_dense_backtrace": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def dense_forward(log_B, log_pi, log_obs: torch.Tensor, lengths):
    """K3: dense batched forward DP. Same contract as dense_forward_plain;
    on the GPU, rows of t1m1 at or beyond a track's length are left
    unwritten."""
    N, T, S = log_obs.shape
    lens = cuda_lib.host_lengths(lengths, N, T)
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    log_pi = torch.as_tensor(log_pi, dtype=torch.float32)
    if log_B.shape != (S, S) or log_pi.shape != (S,):
        raise ValueError(f"bad shapes log_B={tuple(log_B.shape)} log_pi={tuple(log_pi.shape)}")
    if log_obs.device.type == "cpu":
        return dense_forward_plain(log_B, log_pi, log_obs, lens)
    dev = cuda_lib.cuda_operand(log_obs, "log_obs").device
    log_A = log_B.to(dev).t().contiguous()  # log_A[s', s] = log_B[s, s']
    log_pi = log_pi.to(dev).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    t1m1 = torch.empty_like(log_obs)
    t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("viterbi_dense", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_dense_forward(
        P(log_obs), P(log_A), P(log_pi), P(lens_d), P(t1m1), P(t1_last),
        N, T, S, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "dense forward (K3)")
    dense_forward.launches += 1
    return t1_last, t1m1


def dense_backtrace(log_B, t1m1: torch.Tensor, last_states, lengths):
    """K4: dense batched reverse chase. Returns states [N, T] int32;
    entries at or beyond each track's length are unspecified."""
    N, T, S = t1m1.shape
    lens = cuda_lib.host_lengths(lengths, N, T)
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    if log_B.shape != (S, S):
        raise ValueError(f"log_B must be [{S}, {S}], got {tuple(log_B.shape)}")
    if t1m1.device.type == "cpu":
        return dense_backtrace_plain(log_B, t1m1, last_states, lens)
    dev = cuda_lib.cuda_operand(t1m1, "t1m1").device
    log_B = log_B.to(dev).contiguous()
    last = torch.as_tensor(last_states).to(dev, torch.int32).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    states = torch.empty((N, T), dtype=torch.int32, device=dev)
    lib = cuda_lib.load("viterbi_dense", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_dense_backtrace(
        P(t1m1), P(log_B), P(last), P(lens_d), P(states), N, T, S,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "dense backtrace (K4)")
    dense_backtrace.launches += 1
    return states


dense_forward.launches = 0
dense_backtrace.launches = 0

# every kernel wrapper of the decode path, by kernel id
KERNEL_WRAPPERS = {
    "K1": banded_forward,
    "K2": banded_backtrace,
    "K3": dense_forward,
    "K4": dense_backtrace,
    "K5": obs_fused.shaun_log_obs,
    "K6": obs_fused.softmax_log_obs,
    "K9": banded_forward_obs,
}


def viterbi_decode_batch_logobs(
    *, transition_matrix, prob_init, log_obs: torch.Tensor, lengths
) -> torch.Tensor:
    """Decode a [N, T, S] batch of LOG observations (unvoiced state last)
    with per-track lengths. Returns states [N, T] int32 on log_obs's
    device; entries at or beyond each track's length are unspecified."""
    S = np.asarray(transition_matrix).shape[0]
    N, T, S_obs = log_obs.shape
    if S_obs != S:
        raise ValueError(f"log_obs has {S_obs} states, the matrix {S}")
    log_B, log_pi = prepare_log_params(transition_matrix, prob_init)
    bstruct = extract_banded_structure(np.asarray(transition_matrix))
    if bstruct is not None:
        t1_last, t1m1 = banded_forward(bstruct, log_pi, log_obs, lengths)
    else:
        t1_last, t1m1 = dense_forward(log_B, log_pi, log_obs, lengths)
    # first maximum, as np.argmax (documented for torch.argmax)
    last_states = torch.argmax(t1_last[:, :S], dim=1).to(torch.int32)
    if bstruct is not None and bstruct.classes:
        return banded_backtrace(bstruct, t1m1, last_states, lengths)
    return dense_backtrace(log_B, t1m1, last_states, lengths)


def viterbi_decode_batch(
    *, transition_matrix, prob_init, probs_st_list, device=None
) -> list[np.ndarray]:
    """Decode a list of [S, T_i] observation-probability tracks together
    (numpy arrays or tensors). Returns [T_i] int64 state paths, bit-identical
    to the NumPy oracle given the same log observations."""
    dev = resolve_device(device)
    S = np.asarray(transition_matrix).shape[0]
    lengths = [int(p.shape[1]) for p in probs_st_list]
    obs = torch.zeros((len(lengths), max(lengths), S), dtype=torch.float32, device=dev)
    for i, p in enumerate(probs_st_list):
        obs[i, : lengths[i]] = torch.as_tensor(p, dtype=torch.float32).to(dev).T
    states = viterbi_decode_batch_logobs(
        transition_matrix=transition_matrix, prob_init=prob_init,
        log_obs=log_obs_fn(obs), lengths=lengths,
    ).cpu().numpy()
    return [states[i, :L].astype(np.int64) for i, L in enumerate(lengths)]


def viterbi_decode_batch_fused_obs(
    *, transition_matrix, prob_init, logits: torch.Tensor, lengths, obs: dict
) -> torch.Tensor:
    """Decode a [N, T, n_bins] batch of RAW logits with per-track lengths
    (counterpart of viterbi_decode_batch_pallas_fused_obs, without `mesh`).
    obs: the JAX package's obs dict (hmm/obs_fused.py::obs_params). With a
    banded structure: K9, the first-max argmax, then K2 (K4 when the
    structure has no classes); without: K5/K6, then
    viterbi_decode_batch_logobs (K3/K4). Returns states [N, T] int32 on
    the logits' device; entries at or beyond each track's length are
    unspecified."""
    S = np.asarray(transition_matrix).shape[0]
    if logits.shape[-1] + 1 != S:
        raise ValueError(f"logits have {logits.shape[-1]} bins, the matrix {S} states")
    bstruct = extract_banded_structure(np.asarray(transition_matrix))
    if bstruct is None:
        return viterbi_decode_batch_logobs(
            transition_matrix=transition_matrix, prob_init=prob_init,
            log_obs=obs_fused.log_obs(logits, obs), lengths=lengths,
        )
    log_B, log_pi = prepare_log_params(transition_matrix, prob_init)
    t1_last, t1m1 = banded_forward_obs(bstruct, log_pi, logits, lengths, obs)
    last_states = torch.argmax(t1_last[:, :S], dim=1).to(torch.int32)
    if bstruct.classes:
        return banded_backtrace(bstruct, t1m1, last_states, lengths)
    return dense_backtrace(log_B, t1m1, last_states, lengths)
