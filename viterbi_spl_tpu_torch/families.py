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

The note grids come from models/targets.py and imm's f0 grid from
models/imm.py, as in the JAX package. The dcnet
switch matrix is the hard-coded one from
dcnet/viterbi_transition_matrix.py:78-79; other families count it from the
validation split.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hmm.params import single_side_d_max
from .metrics.mel_eval import hz_to_midi
from .models.imm import IMMConfig, imm_f0s
from .models.targets import (
    DCNET_NOTE_RANGE,
    JDC_NOTE_RANGE,
    _msnet_note_range,
    _tonet_note_range,
)


DCNET_SWITCH = np.array(
    [[0.98713454, 0.01286546], [0.01002112, 0.98997888]], np.float64
)
JDC_SWITCH = np.array([[0.9779, 0.0221], [0.0172, 0.9828]], np.float64)


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
                          hz_to_midi(imm_f0s(IMMConfig())).astype(np.float32),
                          threshold_is_logit=True)
    raise KeyError(f"unknown family {name}")


FAMILIES = ("dcnet", "msnet", "ftanet", "jdc", "tonet", "imm")


def family_spec(name: str) -> FamilySpec:
    return _spec(name)
