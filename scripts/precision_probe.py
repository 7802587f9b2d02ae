"""Float32 against float64 in the transcription path's numerics, on the CPU:
the measurements behind the port's float64 front-end chains and its
two-pass BatchNorm variance (viterbi_spl_tpu_torch/frontend/cfp.py,
frontend/stft.py, models/layers.py).

1. cfp: one CFP block (spec, ceps, gcos) of each config on 1 s of a seeded
   harmonic signal with noise and on a plain two-note tone: the JAX
   package's float32 block and the port's (float64) against a float64
   NumPy oracle, the largest |diff| over each part's maximum.
2. jdc: the jdc spectrogram of the JAX package (float32) and of the port
   (float64) against a float64 NumPy reference, on a plain two-note tone
   (tests/test_torch_transcribe.py's wav) and on the noisy signal.
3. variance: flax's BatchNorm variance E[x^2] - E[x]^2 (JAX, float32) and
   the port's two passes (float32), against float64, on chunk means of
   the kind the SF modules normalize (6 chunks, 8 channels, means ~1.5).

    python scripts/precision_probe.py

Needs jax and flax beside torch. Prints one JSON line per reading.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from test_torch_frontend import cfp_oracle_block, jdc_reference, synth_audio  # noqa: E402
from viterbi_spl_tpu import frontend as JF  # noqa: E402
from viterbi_spl_tpu_torch import frontend as TF  # noqa: E402
from viterbi_spl_tpu_torch.models.layers import BatchNorm  # noqa: E402


def two_notes(sr=8000, seconds=1.0):
    """tests/test_torch_transcribe.py::_write_wav's signal, as float32."""
    t = np.arange(int(seconds * sr)) / sr
    f = np.where(t < seconds / 2, 220.0, 330.0)
    x = sum(a * np.sin(2 * np.pi * k * f * t) for k, a in ((1, 0.5), (2, 0.25), (3, 0.125)))
    x = x + np.where(t < seconds / 2, 0.0, 0.05) * np.random.default_rng(7).normal(size=len(t))
    return (np.round(x * 32767 * 0.8) / 32768).astype(np.float32)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cfp(rng):
    cases = [(name, sr, signal) for name, sr in (("TONET_CFP", 8000), ("FTANET_CFP", 8000),
                                                 ("MSNET_CFP", 44100))
             for signal in ("noisy", "two notes")]
    for name, sr, signal in cases:
        cfg = getattr(TF, name)
        y = synth_audio(rng, sr, sr) if signal == "noisy" else two_notes(sr)
        half = cfg.win_len // 2
        n = (len(y) + cfg.hop_size - 1) // cfg.hop_size
        block = np.pad(y, (half, half - 1), mode="reflect")[: (n - 1) * cfg.hop_size + cfg.win_len]
        port = TF.CFP(cfg, device="cpu")
        ref = cfp_oracle_block(block.astype(np.float64), cfg, port.window.astype(np.float64),
                               port.freq_matrix.astype(np.float64),
                               port.quef_matrix.astype(np.float64))
        got = [g.numpy() for g in port._filterbank_block(torch.from_numpy(block))]
        jax_block = [np.asarray(v) for v in JF.CFP(getattr(JF, name))._block_fn(jnp.asarray(block))]
        for part, r, g, j in zip(("spec", "ceps", "gcos"), ref, got, jax_block):
            scale = np.abs(r).max()
            emit({"reading": "cfp", "config": name, "signal": signal, "part": part,
                  "jax_f32_vs_f64": float(np.abs(j - r).max() / scale),
                  "port_vs_f64": float(np.abs(g - r).max() / scale)})


def jdc(rng):
    for label, y in (("two notes", two_notes()), ("noisy", synth_audio(rng, 8000, 8000))):
        ref = jdc_reference(y)
        emit({"reading": "jdc", "signal": label,
              "jax_f32_vs_f64": float(np.abs(JF.jdc_spectrogram(y) - ref).max()),
              "port_vs_f64": float(np.abs(TF.jdc_spectrogram(y, device="cpu") - ref).max())})


def variance(rng):
    class BN(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.BatchNorm(use_running_average=False)(x)

    xs = [rng.normal(size=(6, 40, 32, 8)).astype(np.float32) * 0.1 + 0.5 for _ in range(3)]
    means = sum(xs).mean(axis=(1, 2))  # [6 chunks, 8 channels], as an SF module pools
    m64 = means.astype(np.float64)
    ref = (m64 - m64.mean(0)) / np.sqrt(m64.var(0) + 1e-5)
    model = BN()
    variables = model.init(jax.random.PRNGKey(0), means)
    flax_out = np.asarray(model.apply(variables, means, mutable=["batch_stats"])[0])
    port_out = BatchNorm(8)(torch.from_numpy(means), batch_stats=True).detach().numpy()
    emit({"reading": "variance", "chunks": 6, "channels": 8,
          "var_over_mean_sq": float((m64.var(0) / m64.mean(0) ** 2).min()),
          "flax_f32_vs_f64": float(np.abs(flax_out - ref).max()),
          "port_f32_vs_f64": float(np.abs(port_out - ref).max()),
          "flax_vs_port": float(np.abs(flax_out - port_out).max())})


def main():
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    cfp(rng)
    jdc(rng)
    variance(np.random.default_rng(0))


if __name__ == "__main__":
    main()
