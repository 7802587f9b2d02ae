"""The one traffic generator: everything a run feeds the program, made from
the traffic file's parameters and the run's seed.

- Track lengths: triangular between the traffic file's min and max, with
  its mode, in frames. They are drawn with the traffic file's own
  `length_seed`, so every run seed gets the same set of lengths; the run
  seed only orders them and makes the content. (Runs on different seeds
  then do the same work, and their spread is the system's.)
- Logits: background N(mean, std) per bin, plus `peak` at the bin of a
  melody walk (steps uniform in -step..+step bins a frame, reflected at the
  edges), voiced in runs of `run_frames` frames, each run voiced with
  probability `voiced`; zero past each track's length.
- Audio: a harmonic tone on a seeded melody walk (a note every 0.25 s, MIDI
  48-76, a fifth of the notes silent) plus noise, quantized to 16 bits
  (chip_smoke.py's write_melody_wav recipe).
- Transition matrix and initial probabilities: a seeded note walk,
  counted and shaped with the configuration's d_max, floor and switch rule
  (reference/hmm_params.py).
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one draw of a run, from the run seed and keys."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def track_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths from spec {min, mode, max, length_seed}."""
    rng = np.random.default_rng(int(spec["length_seed"]))
    x = rng.triangular(float(spec["min"]), float(spec["mode"]), float(spec["max"]), n)
    return np.round(x).astype(np.int64)


def reflect(x: torch.Tensor, n: int) -> torch.Tensor:
    period = 2 * (n - 1)
    y = torch.remainder(x, period)
    return torch.minimum(y, period - y)


def melody_bins(n_tracks: int, T: int, n_bins: int, step: int, g: torch.Generator,
                device) -> torch.Tensor:
    """[n_tracks, T] bins of reflected random walks from a uniform start."""
    start = torch.randint(0, n_bins, (n_tracks, 1), generator=g, device=device)
    steps = torch.randint(-step, step + 1, (n_tracks, T), generator=g, device=device)
    steps[:, 0] = 0
    return reflect(start + torch.cumsum(steps, dim=1), n_bins)


def voiced_runs(n_tracks: int, T: int, run: int, share: float, g, device) -> torch.Tensor:
    runs = torch.rand((n_tracks, -(-T // run)), generator=g, device=device) < share
    return runs.repeat_interleave(run, dim=1)[:, :T]


def logits_batch(spec: dict, n_bins: int, lengths, seed: int, device) -> torch.Tensor:
    """[N, max(lengths), n_bins] float32 synthetic logits on `device`."""
    lengths = np.asarray(lengths)
    N, T = len(lengths), int(lengths.max())
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    x = torch.randn((N, T, n_bins), generator=g, device=device)
    x.mul_(float(spec["std"])).add_(float(spec["mean"]))
    bins = melody_bins(N, T, n_bins, int(spec["step"]), g, device)
    voiced = voiced_runs(N, T, int(spec["run_frames"]), float(spec["voiced"]), g, device)
    x.scatter_add_(2, bins[..., None], (voiced.float() * float(spec["peak"]))[..., None])
    valid = torch.arange(T, device=device)[None, :] < torch.as_tensor(lengths, device=device)[:, None]
    return x.mul_(valid[..., None])


def melody_audio(seconds: float, sr: int, seed: int, device) -> np.ndarray:
    """float32 samples of the harmonic melody tone plus noise."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    n_notes = int(np.ceil(seconds / 0.25))
    steps = torch.randint(-2, 3, (n_notes,), generator=g, device=device)
    walk = torch.clamp(62 + torch.cumsum(steps, 0), 48, 76).double()
    voiced = (torch.rand(n_notes, generator=g, device=device) > 0.2).double()
    per, n = int(0.25 * sr), int(seconds * sr)
    f0 = (440.0 * 2.0 ** ((walk - 69) / 12)).repeat_interleave(per)[:n]
    amp = voiced.repeat_interleave(per)[:n]
    phase = 2 * np.pi * torch.cumsum(f0, 0) / sr
    x = sum(a * torch.sin(k * phase) for k, a in ((1, 0.5), (2, 0.25), (3, 0.15), (4, 0.08)))
    x = amp * x + 0.03 * torch.randn(n, generator=g, device=device, dtype=torch.float64)
    pcm = torch.trunc(torch.clamp(x, -1, 1) * 32767 * 0.8)
    return (pcm / 32768.0).float().cpu().numpy()
