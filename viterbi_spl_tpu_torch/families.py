"""Per-family configuration registry (counterpart of
viterbi_spl_tpu/families.py).

One place for the constants each reference script hard-codes (SURVEY.md §0,
§2.3-2.4, BASELINE.md "Hyperparameters selected on validation"):

| family | bins | hop            | spw | d_max            | floor | th    |
|--------|------|----------------|-----|------------------|-------|-------|
| dcnet  | 320  | 256/44100      | 5   | 12               | 6     | 0.31  |
| msnet  | 320  | 256/44100      | 5   | 12               | 6     | 0.54  |
| ftanet | 320  | 80/8000 (10ms) | 5   | 35.92-rule(10ms) | 2     | 0.37  |
| jdc    | 721  | 80/8000 (10ms) | 16  | 40               | 2     | 0.34  |
| tonet  | 360  | 80/8000 (10ms) | 5   | 35.92-rule(10ms) | 2     | 0.32  |
| imm    | 721  | 256/44100      | 20  | analytic         | —     | 2.442347 (log-energy) |

The note grids are own copies of the JAX package's (models/targets.py,
frontend/cfp.py, models/imm.py), reduced to what the decoder needs: the
CFP centre frequencies and the imm f0 grid, not the front-ends themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hmm.params import single_side_d_max
from .metrics.mel_eval import hz_to_midi


def note_grid(note_min: float, n_bins: int, bins_per_semitone: float) -> np.ndarray:
    return (note_min + np.arange(n_bins) / bins_per_semitone).astype(np.float32)


def cfp_central_freqs(fmin: float, fmax: float, bins_per_oct: int = 60) -> np.ndarray:
    """CFPConfig.central_freqs: geometric grid from fmin below fmax
    (frontend/cfp.py:52-59)."""
    fac = 2.0 ** (1.0 / bins_per_oct)
    freqs = []
    f = float(fmin)
    while f < fmax:
        freqs.append(f)
        f *= fac
    return np.asarray(freqs)


def cfp_note_range(central_freqs: np.ndarray) -> np.ndarray:
    """hz_to_midi of central_freqs[1:] (msnet/hsieh_m2m3.py:185-203)."""
    return hz_to_midi(np.asarray(central_freqs)[1:]).astype(np.float32)


def imm_f0s(fmin: float = 100.0, fmax: float = 800.0, bins_per_note: int = 20):
    """imm's f0 grid, fmin * 2**(u / (12 * bins_per_note)) (models/imm.py:
    57-60, 86-88)."""
    U = int(np.ceil(12 * bins_per_note * np.log2(fmax / fmin))) + 1
    return fmin * 2.0 ** (np.arange(U) / float(12 * bins_per_note))


DCNET_NOTE_RANGE = note_grid(23.6, 320, 5)
JDC_NOTE_RANGE = note_grid(38.0, 721, 16)


def _msnet_note_range() -> np.ndarray:
    return cfp_note_range(cfp_central_freqs(31, 1250))


def _tonet_note_range() -> np.ndarray:
    return cfp_note_range(cfp_central_freqs(32, 2050))


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    name: str
    n_bins: int
    hop_seconds: float
    spw: int  # single-side peak width of the observation model
    d_max: int | None  # None = analytic transition (imm)
    floor: int | None
    voicing_threshold: float  # probability (imm: log-energy threshold)
    bins_per_semitone: float
    note_range: np.ndarray
    logits_need_rereference: bool = False  # softmax-head models
    # imm thresholds in the log-energy domain (imm/thresholding.py:80)
    threshold_is_logit: bool = False
    # jdc maps decoded bins to notes directly, without the +/-1-bin
    # probability interpolation (jdc/viterbi_softmax.py:2443-2470)
    interp_est_notes: bool = True

    @property
    def note_min(self) -> float:
        return float(self.note_range[0])


def _spec(name) -> FamilySpec:
    h10ms = 80 / 8000
    h256 = 256 / 44100
    if name == "dcnet":
        return FamilySpec("dcnet", 320, h256, 5, 12, 6, 0.31, 5,
                          DCNET_NOTE_RANGE)
    if name == "msnet":
        return FamilySpec("msnet", 320, h256, 5, 12, 6, 0.54, 5,
                          _msnet_note_range(), logits_need_rereference=True)
    if name == "ftanet":
        return FamilySpec("ftanet", 320, h10ms, 5,
                          single_side_d_max(0.01, 60), 2, 0.37, 5,
                          _msnet_note_range(), logits_need_rereference=True)
    if name == "jdc":
        return FamilySpec("jdc", 721, h10ms, 16, 40, 2, 0.34, 16,
                          JDC_NOTE_RANGE, logits_need_rereference=True,
                          interp_est_notes=False)
    if name == "tonet":
        return FamilySpec("tonet", 360, h10ms, 5,
                          single_side_d_max(0.01, 60), 2, 0.32, 5,
                          _tonet_note_range(), logits_need_rereference=True)
    if name == "imm":
        return FamilySpec("imm", 721, h256, 20, None, None, 2.442347, 20,
                          hz_to_midi(imm_f0s()).astype(np.float32),
                          threshold_is_logit=True)
    raise KeyError(f"unknown family {name}")


FAMILIES = ("dcnet", "msnet", "ftanet", "jdc", "tonet", "imm")


def family_spec(name: str) -> FamilySpec:
    return _spec(name)
