"""The HMM decode, plain PyTorch: the peak-picking observation model of the
paper ("shaun") and a log-domain Viterbi with first-max ties.

Observation model, per frame of [T, n_bins] logits: a bin is a peak when it
is the first maximum of the window of 2 spw + 1 bins centred on it
(reflect-padded); p_voiced = sigmoid(scale (gmax - th) + sign log(p / (1 -
p))) with gmax the largest peak logit and the sign that of gmax - th; the
peaks share p_voiced by a softmax, the unvoiced state (last) takes the rest;
a frame with no peak is unvoiced. Viterbi: with B = log(A^T + tiny),
T1[0] = log(pi + tiny) + log b_0 and T1[t][s] = max_s' (T1[t-1][s'] +
B[s, s']) + log b_t[s], then the chase back from the first maximum of the
last frame. Dense: every state pair, no band.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import EXACT

TINY = float(np.finfo(np.float32).tiny)


def find_peaks(logits: torch.Tensor, spw: int) -> torch.Tensor:
    n = logits.shape[-1]
    idx = torch.as_tensor(np.pad(np.arange(n), spw, mode="reflect"), device=logits.device)
    padded = logits[:, idx]
    win = padded.unfold(1, spw, 1).amax(dim=-1)  # win[i] = max(padded[i .. i + spw - 1])
    return (logits > win[:, :n]) & (logits >= win[:, spw + 1: spw + 1 + n])


def shaun_log_obs(logits: torch.Tensor, threshold_logit: float, spw: int, p: float = 0.8,
                  scale: float = 2.0, precision: str = EXACT) -> torch.Tensor:
    """[T, n_bins] logits -> [T, n_bins + 1] log(observation + tiny), float32.
    The control computes the model in bfloat16."""
    dt = torch.float32 if precision == EXACT else torch.bfloat16
    x = logits.to(dt)
    dev = x.device
    th = torch.tensor(threshold_logit, dtype=dt, device=dev)
    offset = torch.tensor(float(np.log(np.float32(p) / (1 - np.float32(p)))), dtype=dt, device=dev)
    is_peak = find_peaks(x, spw)
    gmax = torch.where(is_peak, x, -torch.inf).amax(dim=1)
    sign = torch.where(gmax >= th, 1.0, -1.0).to(dt)
    p_voiced = torch.where(is_peak.any(dim=1), torch.sigmoid(scale * (gmax - th) + sign * offset),
                           torch.zeros((), dtype=dt, device=dev))
    exps = torch.where(is_peak, torch.exp(x - gmax[:, None]), torch.zeros((), dtype=dt, device=dev))
    voiced = exps * (p_voiced[:, None] / torch.clamp(exps.sum(dim=1, keepdim=True), min=1e-30))
    probs = torch.cat([voiced, (1.0 - p_voiced)[:, None]], dim=1)
    return torch.log(probs.to(torch.float32) + TINY)


def log_params(A: np.ndarray, pi: np.ndarray):
    """(log(A^T + tiny), log(pi + tiny)), float32 NumPy."""
    A = np.asarray(A, np.float32)
    pi = np.asarray(pi, np.float32)
    tiny = np.float32(TINY)
    return np.log(A.T + tiny).astype(np.float32), np.log(pi + tiny).astype(np.float32)


def viterbi(log_B: torch.Tensor, log_pi: torch.Tensor, log_obs: list) -> list:
    """Decode tracks of [T_i, S] log observations together (float32 DP,
    int16 backpointers). Returns [T_i] int64 state paths (CPU tensors)."""
    dev = log_B.device
    lengths = [int(o.shape[0]) for o in log_obs]
    n, T, S = len(lengths), max(lengths), log_B.shape[0]
    obs = torch.zeros((n, T, S), dtype=torch.float32, device=dev)
    for i, o in enumerate(log_obs):
        obs[i, : lengths[i]] = o
    bp = torch.zeros((T, n, S), dtype=torch.int16, device=dev)
    last = torch.empty((n, S), dtype=torch.float32, device=dev)
    ends = {}
    for i, L in enumerate(lengths):
        ends.setdefault(L - 1, []).append(i)
    t1 = log_pi[None, :] + obs[:, 0]
    for t in range(T):
        if t:
            best, arg = (t1[:, None, :] + log_B[None]).max(dim=2)
            bp[t] = arg.to(torch.int16)
            t1 = best + obs[:, t]
        if t in ends:
            rows = torch.as_tensor(ends[t], device=dev)
            last[rows] = t1[rows]
    bp = bp.cpu().numpy()
    state = torch.argmax(last, dim=1).cpu().numpy()
    paths = []
    for i, L in enumerate(lengths):
        path = np.empty(L, np.int64)
        s = int(state[i])
        path[L - 1] = s
        for t in range(L - 1, 0, -1):
            s = int(bp[t, i, s])
            path[t - 1] = s
        paths.append(torch.from_numpy(path))
    return paths


def path_score(log_B: torch.Tensor, log_pi: torch.Tensor, log_obs: torch.Tensor,
               path: torch.Tensor) -> float:
    """log pi + sum of log B and log b along `path`, summed in float64."""
    dev = log_obs.device
    x = torch.as_tensor(path, device=dev).long()
    T = log_obs.shape[0]
    if x.shape != (T,) or int(x.min()) < 0 or int(x.max()) >= log_obs.shape[1]:
        return float("-inf")
    obs = log_obs.double().gather(1, x[:, None])[:, 0]
    trans = log_B.double()[x[1:], x[:-1]]
    return float(log_pi.double()[x[0]] + obs.sum() + trans.sum())


def path_gap(log_B, log_pi, log_obs, ref_path, path) -> float:
    """How far `path` scores below the reference's best, in nats a frame."""
    best = path_score(log_B, log_pi, log_obs, ref_path)
    return (best - path_score(log_B, log_pi, log_obs, path)) / log_obs.shape[0]
