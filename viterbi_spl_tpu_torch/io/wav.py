"""WAV and AIFF loading without librosa/soundfile (counterpart of
viterbi_spl_tpu/io/wav.py, NumPy and SciPy only).

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


def load_aiff(path: str | os.PathLike, mono: bool = True) -> tuple[np.ndarray, int]:
    """AIFF loading (the RWC corpus ships 44.1 kHz stereo aiff files,
    dcnet/main.py:1400-1428). Returns (float32 samples in [-1, 1], sr).

    Uses the stdlib aifc module when present (<= 3.12) with a minimal
    big-endian PCM chunk parser as fallback.
    """
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            import aifc

        with aifc.open(str(path), "rb") as fh:
            n_ch = fh.getnchannels()
            width = fh.getsampwidth()
            sr = int(fh.getframerate())
            raw = fh.readframes(fh.getnframes())
    except ImportError:
        return _load_aiff_raw(path, mono)

    data = _pcm_bytes_to_float32(raw, width, big_endian=True)
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
        if mono:
            data = data.mean(axis=1)
    return data.astype(np.float32), sr


def _pcm_bytes_to_float32(raw: bytes, width: int, big_endian: bool) -> np.ndarray:
    if width == 2:
        dt = ">i2" if big_endian else "<i2"
        return np.frombuffer(raw, dt).astype(np.float32) / 32768.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if big_endian:
            val = (
                b[:, 0].astype(np.int32) << 16
            ) | (b[:, 1].astype(np.int32) << 8) | b[:, 2]
        else:
            val = (
                b[:, 2].astype(np.int32) << 16
            ) | (b[:, 1].astype(np.int32) << 8) | b[:, 0]
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        return val.astype(np.float32) / float(1 << 23)
    if width == 4:
        dt = ">i4" if big_endian else "<i4"
        return np.frombuffer(raw, dt).astype(np.float32) / 2147483648.0
    raise ValueError(f"unsupported aiff sample width {width}")


def _load_aiff_raw(path, mono):
    """Minimal AIFF FORM/COMM/SSND chunk parser (fallback without aifc)."""
    import struct

    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF file")
    pos, n_ch, width, sr, frames = 12, None, None, None, None
    sound = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            n_ch, frames, bits = struct.unpack(">hIh", body[:8])
            width = bits // 8
            # 80-bit extended float sample rate
            exp = struct.unpack(">H", body[8:10])[0] - 16383
            mant = struct.unpack(">Q", body[10:18])[0]
            sr = int(mant / (1 << 63) * (2**exp))
        elif cid == b"SSND":
            offset = struct.unpack(">I", body[:4])[0]
            sound = body[8 + offset :]
        pos += 8 + size + (size & 1)
    if sound is None or width is None:
        raise ValueError("incomplete AIFF file")
    out = _pcm_bytes_to_float32(sound, width, big_endian=True)
    if n_ch and n_ch > 1:
        out = out.reshape(-1, n_ch)
        if mono:
            out = out.mean(axis=1)
    return out.astype(np.float32), sr
