"""Combined Frequency & Periodicity (CFP) front-end in PyTorch (counterpart of
viterbi_spl_tpu/frontend/cfp.py).

Re-design of the reference's tf_cfp.py (one implementation, three configs:
msnet/tf_cfp.py, ftanet/tf_cfp.py:42-57, tonet/tf_cfp.py:60-63):

  STFT (unit-norm blackman-harris, zero-padded FFT) -> power-law compression
  -> generalized cepstrum (irFFT, high-pass lifter, relu, power) ->
  generalized cepstrum of spectrum (rFFT of reflect-padded cepstrum,
  high-pass, relu, power) -> triangular log-frequency filterbanks (freq->
  log-freq for spec/gcos, quefrency->log-freq for ceps) -> per-feature
  log1p + global min-max normalization -> [T, n_bins, 3] feature stack.

Long audio runs through 45 s blocks with window-length overlap
(msnet/tf_cfp.py:89-100, 339-402). Every block runs on the device
(torch.fft and the filterbank matrix products), and the whole-track
normalization runs there too once all blocks are done; features come out
float32.

The chain computes in float64 (the JAX package's in float32). The 0.24
power of the STFT magnitude lifts the window's sidelobe floor, ~92 dB under
a frame's peak, where a float32 FFT's rounding is a large relative error,
and the cepstra sum those bins: on a plain tone the JAX package's float32
block is up to 3.5e-3 of a part's maximum off a float64 oracle, this one
1.5e-7 (scripts/precision_probe.py), and float32 chains on two FFT
libraries (the card's and the CPU's) give features apart by far more than
their rounding once the min-max normalization has scaled them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import tracing
from ..utils import resolve_device
from .stft import stft_frames, unit_norm_blackmanharris


@dataclasses.dataclass(frozen=True)
class CFPConfig:
    sr: int
    win_len: int
    hop_size: int
    fmin: float
    fmax: float
    bins_per_oct: int = 60
    gammas: tuple[float, float, float] = (0.24, 0.6, 1.0)
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
        freqs = []
        f = float(self.fmin)
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


MSNET_CFP = CFPConfig(sr=44100, win_len=2048, hop_size=256, fmin=31, fmax=1250)
FTANET_CFP = CFPConfig(sr=8000, win_len=768, hop_size=80, fmin=31, fmax=1250)
TONET_CFP = CFPConfig(sr=8000, win_len=768, hop_size=80, fmin=32, fmax=2050)


def _freq_to_logfreq_matrix(config: CFPConfig) -> np.ndarray:
    """[HighFreqIdx+1, n_bins]: linear-frequency bins (k * fr) onto triangular
    log-frequency filters (msnet/tf_cfp.py:142-191)."""
    high = int(config.fmax / config.fr)
    grid = np.arange(high + 1) * config.fr
    centers = config.central_freqs
    n_filters = len(centers) - 1
    W = np.zeros((n_filters, high + 1), np.float64)
    for k in range(1, n_filters):
        lo, c, hi = centers[k - 1], centers[k], centers[k + 1]
        l = int(np.ceil(lo / config.fr))
        r = int(hi / config.fr)
        if l >= r:
            if l <= high:
                W[k, l] = 1.0
            continue
        for j in range(l, r + 1):
            g = grid[j]
            W[k, j] = (g - lo) / (c - lo) if g <= c else (hi - g) / (hi - c)
    return W.astype(np.float32).T


def _quef_to_logfreq_matrix(config: CFPConfig) -> np.ndarray:
    """[HighQuefIdx+1, n_bins]: quefrency bins (freq = sr / q) onto the same
    triangular log-frequency filters (msnet/tf_cfp.py:193-237)."""
    fs = float(config.sr)
    high = int(fs / config.fmin)
    centers = config.central_freqs
    n_filters = len(centers) - 1
    W = np.zeros((n_filters, high + 1), np.float64)
    for k in range(1, n_filters):
        lo, c, hi = centers[k - 1], centers[k], centers[k + 1]
        ql = int(np.ceil(fs / hi))
        qr = int(fs / lo)
        for q in range(ql, qr + 1):
            g = fs / q
            W[k, q] = (g - lo) / (c - lo) if g <= c else (hi - g) / (hi - c)
    return W.astype(np.float32).T


class CFP:
    """Callable CFP front-end. `features(samples)` -> [T, n_bins, 3], computed
    on `device` (CUDA by default)."""

    def __init__(self, config: CFPConfig = MSNET_CFP, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.window = unit_norm_blackmanharris(config.win_len)
        self.freq_matrix = _freq_to_logfreq_matrix(config)
        self.quef_matrix = _quef_to_logfreq_matrix(config)
        f64 = torch.float64
        self._window = tracing.upload(self.window, self.device, "front_end", f64)
        self._wf = tracing.upload(self.freq_matrix, self.device, "front_end", f64)
        self._wq = tracing.upload(self.quef_matrix, self.device, "front_end", f64)

    def _filterbank_block(self, samples: torch.Tensor):
        """One block of float32 samples -> (spec, ceps, gcos) [n_frames,
        n_bins] float64. Mirrors msnet/tf_cfp.py:239-324 step for step."""
        cfg = self.config
        g0, g1, g2 = (float(np.float32(g)) for g in cfg.gammas)
        N = cfg.fft_len
        hNp1 = N // 2 + 1
        fr, fs = cfg.fr, float(cfg.sr)

        spec = stft_frames(samples.to(torch.float64), self._window, N, cfg.hop_size).abs() ** g0

        # generalized cepstrum
        ceps = torch.fft.irfft(spec.to(torch.complex128), n=N, dim=-1)
        ceps = ceps[:, :hNp1] * np.sqrt(N)
        cutoff_q = int(fs / cfg.fmax)  # inclusive high-pass lifter
        ceps[:, : cutoff_q + 1] = 0.0
        ceps = torch.clamp(ceps, min=0.0) ** g1

        # generalized cepstrum of spectrum
        padded = torch.nn.functional.pad(ceps[None], (0, N // 2 - 1), mode="reflect")[0]
        gcos = torch.fft.rfft(padded, dim=-1).real / np.sqrt(N)
        cutoff_f = int(cfg.fmin / fr)
        gcos = gcos[:, : hNp1 - 1]  # drop Nyquist (reference slices :-1)
        gcos[:, : cutoff_f + 1] = 0.0
        gcos = torch.clamp(gcos, min=0.0)
        if g2 != 1.0:
            gcos = gcos ** g2

        high_f = int(cfg.fmax / fr)
        high_q = int(fs / cfg.fmin)
        spec = spec[:, :-1][:, : high_f + 1]
        gcos = gcos[:, : high_f + 1]
        ceps = ceps[:, :-1][:, : high_q + 1]
        return spec @ self._wf, ceps @ self._wq, gcos @ self._wf

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        """log1p + global min-max (msnet/tf_cfp.py:326-337); left unscaled
        when max ~= min. Its two reads of the card are `front_end.wait`
        spans."""
        x = torch.log1p(x)
        lo, hi = x.min(), x.max()
        if float(tracing.to_host(hi, "front_end")) > float(tracing.to_host(lo, "front_end")) + 1e-3:
            x = (x - lo) / (hi - lo)
        return x

    def features(self, samples: np.ndarray) -> np.ndarray:
        """Whole-track CFP features [total_num_frames, n_bins, 3], float32.

        Reflect-pads half a window each side, splits into 45 s frame blocks
        with window-length overlap, runs each block on the device, then
        applies the per-feature whole-track normalization
        (msnet/tf_cfp.py:339-402).
        """
        cfg = self.config
        samples = np.asarray(samples, np.float32)
        half = cfg.win_len // 2
        total_frames = (len(samples) + cfg.hop_size - 1) // cfg.hop_size
        padded = np.pad(samples, (half, half - 1), mode="reflect")
        needed = (total_frames - 1) * cfg.hop_size + cfg.win_len
        if needed > len(padded):
            raise ValueError("padding shortfall")
        padded = tracing.upload(padded[:needed], self.device, "front_end")

        starts = list(range(0, total_frames, cfg.max_num_frames)) + [total_frames]
        outs = ([], [], [])
        with tracing.span("front_end.blocks"):
            for s, e in zip(starts[:-1], starts[1:]):
                s0 = s * cfg.hop_size
                e0 = (e - s - 1) * cfg.hop_size + s0 + cfg.win_len
                for i, part in enumerate(self._filterbank_block(padded[s0:e0])):
                    if tuple(part.shape) != (e - s, cfg.n_bins):
                        raise AssertionError(f"block shape {tuple(part.shape)}")
                    outs[i].append(part)
        parts = [self._normalize(torch.cat(o, dim=0)) for o in outs]
        feat = tracing.to_host(torch.stack(parts, dim=-1).to(torch.float32), "front_end").numpy()
        return np.require(feat, requirements=["C"])

    def features_tonet(self, samples: np.ndarray) -> np.ndarray:
        """TONet layout: [3, n_bins, T] (tonet/tf_cfp.py:400)."""
        return np.ascontiguousarray(self.features(samples).transpose(2, 1, 0))
