"""The jdc spectrogram (the reference code's jdc/kum_m2m3.py:495-509) in plain
PyTorch, float64: the samples reflect-padded by n_fft / 2 on both sides,
frames of 1,024 samples every 80 (10 ms at 8 kHz) under a periodic hann
window, their rFFT's magnitude, then librosa's power_to_db(ref=max,
amin=1e-10, top_db=80) scaled by 1/80 and lifted by 1, [T, 513] float32
out, T = 1 + len(samples) // 80.

Departures from the published description:
- None in the arithmetic. As the reference code does, power_to_db takes
  the magnitude |S|, not the power |S|^2, so a bin's value is 10 log10 |S|.
- The window, computed from its formula, is rounded to float32, as the
  program's is (scipy's, cast). The rounding moves a bin by up to 6e-8 of
  the frame's peak magnitude, which near the 80 dB floor is several times
  1e-6 of the output's range.

The control computes every step in float32 (`precision.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import EXACT

N_FFT, HOP = 1024, 80


def jdc_spectrogram(samples: np.ndarray, device, precision: str = EXACT) -> torch.Tensor:
    """[T, 513] float32 on `device`."""
    dt = torch.float64 if precision == EXACT else torch.float32
    y = np.pad(np.asarray(samples, np.float64), N_FFT // 2, mode="reflect")
    y = torch.as_tensor(y, dtype=dt, device=device)
    n = torch.arange(N_FFT, dtype=dt, device=device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).to(torch.float32).to(dt)
    frames = y.unfold(0, N_FFT, HOP) * window
    mag = torch.fft.rfft(frames, n=N_FFT, dim=-1).abs()
    amin = 1e-10
    db = 10.0 * torch.log10(torch.clamp(mag, min=amin)) - 10.0 * torch.log10(
        torch.clamp(mag.max(), min=amin))
    db = torch.maximum(db, db.max() - 80.0)
    return (db / 80.0 + 1.0).to(torch.float32)
