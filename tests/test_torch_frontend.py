"""The port's audio front-ends (viterbi_spl_tpu_torch/io/wav.py,
frontend/stft.py, frontend/cfp.py) against the JAX package's, on the CPU,
on the same seeded audio.

Tolerances and where they come from:
- wav loading (scipy on both sides): bit-equal.
- the framed STFT: bit-equal framing; the rFFT within rtol 1e-3, atol 1e-4
  of JAX's, tests/test_frontend.py:51's bound against NumPy.
- the jdc spectrogram (the port's in float64): within 1e-6 of a float64
  NumPy reference in its [0, 1] scale, and within 5e-4 of the JAX
  package's float32 one on this noisy signal, whose own error against the
  reference is 1.6e-4 on such a signal and 0.024 on a plain tone, where
  bins sit near the 80 dB floor (scripts/precision_probe.py; the port's
  3e-8).
- the sinebell pair: the JAX test's SNR > 60 dB round trip
  (tests/test_frontend.py:62), and the forward within the STFT's bound.
- a CFP block (spec, ceps, gcos before normalization; the port computes
  it in float64): against a float64 NumPy oracle (the steps of
  tests/test_frontend.py:85-118), 1e-6 of each part's maximum (the port's
  error there is <= 1.5e-7, scripts/precision_probe.py); against the JAX
  package's float32 block, 2e-3 of it at 8 kHz, tests/test_frontend.py:143's
  bound, and 2e-2 at msnet's 44.1 kHz. The JAX block's own float32 error
  against the oracle is up to 5.2e-5 on noisy audio and 3.5e-3 on a plain
  tone (the 0.24 power lifts the STFT's sidelobe floor, where float32
  rounding is a large relative error).
- whole-track CFP features, after the log1p and min-max normalization:
  atol 1e-3 (the blocks' float32 error, scaled by the normalization).
- blocked (1 s blocks) against one block: atol 1e-5, as
  tests/test_frontend.py:167-171.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu import frontend as JF
from viterbi_spl_tpu.frontend import stft as JS
from viterbi_spl_tpu.io import wav as JW
from viterbi_spl_tpu_torch import frontend as TF
from viterbi_spl_tpu_torch.frontend import stft as TS
from viterbi_spl_tpu_torch.io import wav as TW

CPU = "cpu"


def synth_audio(rng, n, sr, freqs=(220.0, 440.0, 660.0)):
    t = np.arange(n) / sr
    y = sum(a * np.sin(2 * np.pi * f * t) for a, f in zip((0.5, 0.3, 0.2), freqs))
    return (y + 0.01 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("sr", [8000, 44100])
def test_load_wav_matches_jax(tmp_path, rng, dtype, sr):
    """Stereo 16 kHz PCM16 and float32 files: mono mixdown and the polyphase
    resampling to 8 kHz or 44.1 kHz, bit-equal to the JAX package's; and
    save_wav's PCM16 file reads back equal through both."""
    x = synth_audio(rng, 4000, 16000)
    stereo = np.stack([x, 0.5 * x], axis=1)
    data = (stereo * 20000).astype(np.int16) if dtype == np.int16 else stereo
    path = tmp_path / "in.wav"
    wavfile.write(path, 16000, data)
    got, got_sr = TW.load_wav(path, sr=sr)
    want, want_sr = JW.load_wav(path, sr=sr)
    assert got_sr == want_sr == sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if dtype == np.int16:  # the wave module reads PCM headers only
        assert dataclasses.astuple(TW.wav_info(path)) == dataclasses.astuple(JW.wav_info(path))
    TW.save_wav(tmp_path / "a.wav", 2.0 * got, sr)
    JW.save_wav(tmp_path / "b.wav", 2.0 * got, sr)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_frame_signal_and_stft_match_jax(rng):
    x = np.arange(10.0, dtype=np.float32)
    np.testing.assert_array_equal(TS.frame_signal(torch.from_numpy(x), 4, 2).numpy(),
                                  np.asarray(JS.frame_signal(jnp.asarray(x), 4, 2)))
    y = synth_audio(rng, 4000, 8000)
    win = TS.unit_norm_blackmanharris(768)
    np.testing.assert_array_equal(win, JS.unit_norm_blackmanharris(768))
    got = TS.stft_frames(torch.from_numpy(y), torch.from_numpy(win), 4000, 80).numpy()
    want = np.asarray(JS.stft_frames(jnp.asarray(y), jnp.asarray(win), 4000, 80))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def jdc_reference(samples):
    """jdc_spectrogram's steps in float64 NumPy."""
    from scipy.signal.windows import hann

    n_fft, hop = 1024, 80
    w = hann(n_fft, sym=False).astype(np.float32).astype(np.float64)
    y = np.pad(np.asarray(samples, np.float64), n_fft // 2, mode="reflect")
    frames = np.stack([y[i * hop: i * hop + n_fft] * w for i in range((len(y) - n_fft) // hop + 1)])
    spec = np.abs(np.fft.rfft(frames, n=n_fft))
    db = 10 * np.log10(np.maximum(spec, 1e-10)) - 10 * np.log10(max(spec.max(), 1e-10))
    return np.maximum(db, db.max() - 80) / 80 + 1


def test_jdc_spectrogram_matches_reference_and_jax(rng):
    y = synth_audio(rng, 8000, 8000)
    got = TS.jdc_spectrogram(y, device=CPU)
    want = JF.jdc_spectrogram(y)
    assert got.shape == want.shape == (101, 513) and got.dtype == np.float32
    np.testing.assert_allclose(got, jdc_reference(y), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert got.max() == pytest.approx(1.0) and got.min() >= -1e-6


def test_sinebell_matches_jax_and_round_trips(rng):
    y = synth_audio(rng, 44100, 44100)
    port = TS.SinebellSTFT(w=2048, h=256, device=CPU)
    spec = port.stft(y)
    want = np.asarray(JF.SinebellSTFT(w=2048, h=256).stft(y))
    assert spec.shape == want.shape == (port.num_frames(len(y)), 1025)
    np.testing.assert_allclose(spec.numpy(), want, rtol=1e-3, atol=1e-4)
    y2 = port.istft(spec).numpy()[: len(y)]
    err = np.abs(y2 - y)[2048:-2048]
    snr = 10 * np.log10(np.mean(y**2) / max(np.mean(err**2), 1e-20))
    assert snr > 60, f"reconstruction SNR too low: {snr:.1f} dB"


@pytest.mark.parametrize("name", ["TONET_CFP", "FTANET_CFP", "MSNET_CFP"])
def test_cfp_config_and_matrices_match_jax(name):
    t_cfg, j_cfg = getattr(TF, name), getattr(JF, name)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.n_bins == j_cfg.n_bins and t_cfg.fft_len == j_cfg.fft_len
    np.testing.assert_array_equal(t_cfg.central_freqs, j_cfg.central_freqs)
    t, j = TF.CFP(t_cfg, device=CPU), JF.CFP(j_cfg)
    np.testing.assert_array_equal(t.freq_matrix, j.freq_matrix)
    np.testing.assert_array_equal(t.quef_matrix, j.quef_matrix)


def cfp_oracle_block(samples, cfg, window, Wf, Wq):
    """The CFP filterbank chain step by step in float64 NumPy (the steps of
    tests/test_frontend.py::_cfp_oracle_block, msnet/tf_cfp.py:239-324)."""
    N, hop = cfg.fft_len, cfg.hop_size
    hNp1 = N // 2 + 1
    g0, g1, g2 = cfg.gammas
    n_frames = (len(samples) - cfg.win_len) // hop + 1
    frames = np.stack([samples[i * hop: i * hop + cfg.win_len] * window for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames, n=N, axis=-1)) ** g0
    ceps = np.fft.irfft(spec.astype(np.complex128), n=N, axis=-1)[:, :hNp1] * np.sqrt(N)
    ceps[:, : int(cfg.sr / cfg.fmax) + 1] = 0
    ceps = np.maximum(ceps, 0) ** g1
    padded = np.pad(ceps, [(0, 0), (0, N // 2 - 1)], mode="reflect")
    gcos = np.real(np.fft.rfft(padded, axis=-1))[:, : hNp1 - 1] / np.sqrt(N)
    gcos[:, : int(cfg.fmin / cfg.fr) + 1] = 0
    gcos = np.maximum(gcos, 0) ** g2
    high_f, high_q = int(cfg.fmax / cfg.fr), int(cfg.sr / cfg.fmin)
    return (spec[:, :-1][:, : high_f + 1] @ Wf, ceps[:, :-1][:, : high_q + 1] @ Wq,
            gcos[:, : high_f + 1] @ Wf)


@pytest.mark.parametrize("name,sr,seconds,jax_tol", [("TONET_CFP", 8000, 1.0, 2e-3),
                                                     ("FTANET_CFP", 8000, 1.0, 2e-3),
                                                     ("MSNET_CFP", 44100, 0.5, 2e-2)])
def test_cfp_block_matches_oracle_and_jax(rng, name, sr, seconds, jax_tol):
    """One block's (spec, ceps, gcos) before normalization, each scaled by
    its maximum: within 1e-6 of the float64 oracle, and within jax_tol of
    the JAX package's float32 block."""
    cfg = getattr(TF, name)
    y = synth_audio(rng, int(sr * seconds), sr)
    half = cfg.win_len // 2
    n_frames = (len(y) + cfg.hop_size - 1) // cfg.hop_size
    block = np.pad(y, (half, half - 1), mode="reflect")[: (n_frames - 1) * cfg.hop_size + cfg.win_len]
    port = TF.CFP(cfg, device=CPU)
    got = port._filterbank_block(torch.from_numpy(block))
    want = cfp_oracle_block(block.astype(np.float64), cfg, port.window.astype(np.float64),
                            port.freq_matrix.astype(np.float64),
                            port.quef_matrix.astype(np.float64))
    jax_block = JF.CFP(getattr(JF, name))._block_fn(jnp.asarray(block))
    for g, w, j, part in zip(got, want, jax_block, ("spec", "ceps", "gcos")):
        g, j = g.numpy(), np.asarray(j)
        assert g.shape == w.shape == j.shape == (n_frames, cfg.n_bins), part
        scale = max(np.abs(w).max(), 1e-9)
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-6, err_msg=part)
        np.testing.assert_allclose(g / scale, j / scale, atol=jax_tol, err_msg=part)


def test_cfp_features_match_jax_and_block_seamlessly(rng):
    """Whole-track features within atol 1e-3 of the JAX package's; the
    port's own 1 s blocks equal its one block within atol 1e-5; tonet's
    layout is the features transposed."""
    y = synth_audio(rng, 8000 * 3, 8000)
    cfp = TF.CFP(TF.TONET_CFP, device=CPU)
    got = cfp.features(y)
    want = JF.CFP(JF.TONET_CFP).features(y)
    assert got.shape == want.shape == (300, 360, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert got.max() == pytest.approx(1.0) and got.min() >= 0.0
    small = TF.CFP(dataclasses.replace(TF.TONET_CFP, max_block_seconds=1), device=CPU)
    np.testing.assert_allclose(small.features(y), got, atol=1e-5)
    np.testing.assert_array_equal(cfp.features_tonet(y), got.transpose(2, 1, 0))


def test_front_ends_default_to_cuda():
    """Without a device the front-ends ask for CUDA, and say so where there
    is none; they do not fall back to the CPU."""
    if torch.cuda.is_available():
        assert TF.CFP(TF.TONET_CFP).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.CFP(TF.TONET_CFP)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.jdc_spectrogram(np.zeros(2000, np.float32))
