"""The CFP front-end (combined frequency and periodicity), plain PyTorch.

A frozen copy of the CFP chain as published with MSNet/FTANet/TONet
(tf_cfp.py in those repositories): unit-norm periodic Blackman-Harris STFT,
power-law compression, generalized cepstrum with a high-pass lifter,
generalized cepstrum of spectrum, triangular log-frequency filterbanks,
log1p and a whole-track min-max normalization, in 45 s blocks that overlap
by a window. "exact" runs in float64, "control" in float32.
Output [T, n_bins, 3] float32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy.signal.windows import blackmanharris

from .precision import EXACT


@dataclasses.dataclass(frozen=True)
class CFPConfig:
    sr: int
    win_len: int
    hop_size: int
    fmin: float
    fmax: float
    bins_per_oct: int = 60
    gammas: tuple = (0.24, 0.6, 1.0)
    max_block_seconds: int = 45

    @property
    def fft_len(self) -> int:
        n = int(np.ceil(self.sr / 2.0))
        return n + 1 if n % 2 == 1 else n

    @property
    def fr(self) -> float:
        return float(self.sr) / self.fft_len

    @functools.cached_property
    def central_freqs(self) -> np.ndarray:
        fac = 2.0 ** (1.0 / self.bins_per_oct)
        freqs, f = [], float(self.fmin)
        while f < self.fmax:
            freqs.append(f)
            f *= fac
        return np.asarray(freqs)

    @property
    def n_bins(self) -> int:
        return len(self.central_freqs) - 1

    @property
    def max_num_frames(self) -> int:
        return self.max_block_seconds * self.sr // self.hop_size


def freq_matrix(cfg: CFPConfig) -> np.ndarray:
    """[high_f + 1, n_bins] triangular filters over linear-frequency bins."""
    high = int(cfg.fmax / cfg.fr)
    grid = np.arange(high + 1) * cfg.fr
    c = cfg.central_freqs
    W = np.zeros((len(c) - 1, high + 1), np.float64)
    for k in range(1, len(c) - 1):
        lo, mid, hi = c[k - 1], c[k], c[k + 1]
        l, r = int(np.ceil(lo / cfg.fr)), int(hi / cfg.fr)
        if l >= r:
            if l <= high:
                W[k, l] = 1.0
            continue
        for j in range(l, r + 1):
            g = grid[j]
            W[k, j] = (g - lo) / (mid - lo) if g <= mid else (hi - g) / (hi - mid)
    return W.astype(np.float32).T


def quef_matrix(cfg: CFPConfig) -> np.ndarray:
    """[high_q + 1, n_bins] the same filters over quefrency bins (f = sr / q)."""
    fs = float(cfg.sr)
    high = int(fs / cfg.fmin)
    c = cfg.central_freqs
    W = np.zeros((len(c) - 1, high + 1), np.float64)
    for k in range(1, len(c) - 1):
        lo, mid, hi = c[k - 1], c[k], c[k + 1]
        for q in range(int(np.ceil(fs / hi)), int(fs / lo) + 1):
            g = fs / q
            W[k, q] = (g - lo) / (mid - lo) if g <= mid else (hi - g) / (hi - mid)
    return W.astype(np.float32).T


def _block(cfg, samples, window, wf, wq, dt):
    g0, g1, g2 = (float(np.float32(g)) for g in cfg.gammas)
    N = cfg.fft_len
    half = N // 2 + 1
    fs = float(cfg.sr)
    frames = samples.unfold(0, window.shape[0], cfg.hop_size) * window[None, :]
    spec = torch.fft.rfft(frames, n=N, dim=-1).abs() ** g0
    ceps = torch.fft.irfft(spec.to(torch.complex128 if dt == torch.float64 else torch.complex64),
                           n=N, dim=-1)[:, :half] * np.sqrt(N)
    ceps[:, : int(fs / cfg.fmax) + 1] = 0.0
    ceps = torch.clamp(ceps, min=0.0) ** g1
    padded = torch.nn.functional.pad(ceps[None], (0, N // 2 - 1), mode="reflect")[0]
    gcos = torch.fft.rfft(padded, dim=-1).real[:, : half - 1] / np.sqrt(N)
    gcos[:, : int(cfg.fmin / cfg.fr) + 1] = 0.0
    gcos = torch.clamp(gcos, min=0.0)
    if g2 != 1.0:
        gcos = gcos ** g2
    high_f, high_q = int(cfg.fmax / cfg.fr), int(fs / cfg.fmin)
    spec = spec[:, :-1][:, : high_f + 1]
    gcos = gcos[:, : high_f + 1]
    ceps = ceps[:, :-1][:, : high_q + 1]
    return spec @ wf, ceps @ wq, gcos @ wf


def _normalize(x):
    x = torch.log1p(x)
    lo, hi = x.min(), x.max()
    if float(hi) > float(lo) + 1e-3:
        x = (x - lo) / (hi - lo)
    return x


def cfp_features(cfg: CFPConfig, samples: np.ndarray, device, precision: str = EXACT) -> torch.Tensor:
    """samples [n] float32 -> [T, n_bins, 3] float32 on `device`."""
    dt = torch.float64 if precision == EXACT else torch.float32
    w = blackmanharris(cfg.win_len, sym=False).astype(np.float32)
    window = torch.from_numpy(w / np.linalg.norm(w)).to(device, dt)
    wf = torch.from_numpy(freq_matrix(cfg)).to(device, dt)
    wq = torch.from_numpy(quef_matrix(cfg)).to(device, dt)
    samples = np.asarray(samples, np.float32)
    half = cfg.win_len // 2
    total = (len(samples) + cfg.hop_size - 1) // cfg.hop_size
    padded = np.pad(samples, (half, half - 1), mode="reflect")
    padded = torch.from_numpy(padded[: (total - 1) * cfg.hop_size + cfg.win_len]).to(device, dt)
    starts = list(range(0, total, cfg.max_num_frames)) + [total]
    outs = ([], [], [])
    for s, e in zip(starts[:-1], starts[1:]):
        s0 = s * cfg.hop_size
        e0 = (e - s - 1) * cfg.hop_size + s0 + cfg.win_len
        for i, part in enumerate(_block(cfg, padded[s0:e0], window, wf, wq, dt)):
            outs[i].append(part)
    return torch.stack([_normalize(torch.cat(o)) for o in outs], dim=-1).to(torch.float32)
