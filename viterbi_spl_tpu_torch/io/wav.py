"""WAV loading without librosa/soundfile (counterpart of
viterbi_spl_tpu/io/wav.py, NumPy and SciPy only; its AIFF reader, which
only the RWC corpus needs, waits for the data slice).

Reproduces the behaviors the reference relies on (librosa.load / soundfile):
float32 samples scaled to [-1, 1], optional mono mixdown (channel mean),
optional resampling (polyphase; reference uses librosa's default resampler —
numerically different but spectrally equivalent). Reference call sites:
msnet/tf_cfp.py:349-355, jdc/kum_m2m3.py:495-509, imm/tf_imm.py:659-678.
"""

from __future__ import annotations

import dataclasses
import os
import wave

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


@dataclasses.dataclass(frozen=True)
class WavInfo:
    samplerate: int
    frames: int
    channels: int
    subtype: str


def wav_info(path: str | os.PathLike) -> WavInfo:
    """Metadata without reading samples (mirrors soundfile.info usage)."""
    with wave.open(str(path), "rb") as fh:
        width = fh.getsampwidth()
        subtype = {1: "PCM_U8", 2: "PCM_16", 3: "PCM_24", 4: "PCM_32"}.get(
            width, f"WIDTH_{width}"
        )
        return WavInfo(
            samplerate=fh.getframerate(),
            frames=fh.getnframes(),
            channels=fh.getnchannels(),
            subtype=subtype,
        )


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    raise ValueError(f"unsupported wav dtype {data.dtype}")


def load_wav(
    path: str | os.PathLike,
    sr: int | None = None,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """Load a wav file -> (float32 samples, sample_rate).

    Returns shape [num_samples] when mono, else [num_samples, channels].
    When ``sr`` differs from the file rate, resamples with a polyphase
    filter (scipy.signal.resample_poly).
    """
    file_sr, data = wavfile.read(str(path))
    samples = _to_float32(np.asarray(data))
    if mono and samples.ndim == 2:
        samples = samples.mean(axis=1)
    if sr is not None and sr != file_sr:
        from math import gcd

        g = gcd(sr, file_sr)
        samples = resample_poly(samples, sr // g, file_sr // g, axis=0)
        samples = samples.astype(np.float32)
        file_sr = sr
    if np.any(np.isnan(samples)):
        raise ValueError(f"NaNs in decoded audio: {path}")
    return samples, file_sr


def save_wav(path: str | os.PathLike, samples: np.ndarray, sr: int) -> None:
    """float32 [n] or [n, channels] in [-1, 1] -> PCM16 wav (the separation
    resynthesis outputs, imm/tf_imm.py:354-618 drivers)."""
    samples = np.asarray(samples)
    peak = np.max(np.abs(samples)) if samples.size else 0.0
    if peak > 1.0:
        samples = samples / peak
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype(np.int16)
    wavfile.write(str(path), sr, pcm)
