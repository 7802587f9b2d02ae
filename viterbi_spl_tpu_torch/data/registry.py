"""Track registry (counterpart of viterbi_spl_tpu/data/registry.py, its
`Track` record only: the dataset roots and TrackDataset wait for the data
slice)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Track:
    track_id: str
    spectrogram: np.ndarray  # [T, ...] float32
    notes: np.ndarray  # [T] float32 MIDI, 0 = unvoiced
    original_times: np.ndarray
    original_freqs: np.ndarray

    @property
    def num_frames(self) -> int:
        return len(self.spectrogram)
