"""Track registry: whole-recording features + labels, cached in memory
(counterpart of viterbi_spl_tpu/data/registry.py).

Re-design of the per-script TFDataset hierarchy (dcnet/softmax_viterbi.py:
409-742): whole-track spectrograms and note labels are precomputed once
into immutable arrays; snippet serving is a separate, front-end-agnostic
concern (snippets.py). Dataset roots come from the same environment
variables the reference uses (medleydb, melody2_dir, adc04, mirex05,
mir1k, rwc, section_dir).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np

ENV_ROOTS = (
    "medleydb",
    "melody2_dir",
    "adc04",
    "mirex05",
    "mir1k",
    "rwc",
    "section_dir",
)


def dataset_roots() -> dict[str, str | None]:
    return {k: os.environ.get(k) for k in ENV_ROOTS}


def _freeze(arr: np.ndarray) -> np.ndarray:
    """The reference's immutability discipline: owned, C-contiguous,
    non-writeable (dcnet/softmax_viterbi.py:530-534)."""
    arr = np.require(arr, requirements=["O", "C"])
    arr.flags["WRITEABLE"] = False
    return arr


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


def reconcile_lengths(
    spec: np.ndarray, notes: np.ndarray, max_diff: int = 1,
    pad_short_notes: bool = False,
    max_undershoot: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Labels may exceed the spectrogram by up to `max_diff` frames; pad the
    spectrogram to match (dcnet/softmax_viterbi.py:522-528,
    jdc/kum_m2m3.py:440-446 uses max_diff=2). With pad_short_notes, labels
    SHORTER than the spectrogram are zero-padded (unvoiced) instead — the
    mir1k rule, where the .pv grid undershoots the audio length
    (dcnet/softmax_viterbi.py:1262-1268 pads either side). `max_undershoot`
    overrides the default corrupt-annotation cap for corpus/front-end
    pairings with a known-larger legitimate deficit (coarser label grid or
    longer analysis tail)."""
    diff = len(notes) - len(spec)
    if diff < 0 and pad_short_notes:
        # the reference pads the deficit unbounded but PRINTS the diffs
        # (dcnet/softmax_viterbi.py:1262-1268 collects `diffs`); mirror
        # that visibility, and refuse plainly-corrupt annotations (a .pv
        # covering half the track) instead of silently scoring the missing
        # frames as unvoiced. Legitimate undershoots are the analysis tail
        # the label grid cannot cover (~window/hop frames, <= ~10).
        cap = max(32, len(spec) // 10) if max_undershoot is None \
            else max_undershoot
        if -diff > cap:
            raise ValueError(
                f"labels undershoot the spectrogram by {-diff} of "
                f"{len(spec)} frames — annotation/audio mismatch"
            )
        if -diff > max_diff:
            import logging

            logging.warning(
                "zero-padding %d missing label frames (spec %d)",
                -diff, len(spec),
            )
        notes = np.pad(notes, (0, -diff))
        return spec, notes
    if not (0 <= diff <= max_diff):
        raise ValueError(f"spec/label length difference {diff} out of range")
    if diff:
        pad = [(0, diff)] + [(0, 0)] * (spec.ndim - 1)
        spec = np.pad(spec, pad)
    return spec, notes


class TrackDataset:
    """A split's tracks with precomputed features and labels.

    spec_fn: track_id -> [T, ...] float32 feature array.
    label_fn: track_id -> dict(notes=..., original=dict(times, freqs)).
    """

    def __init__(
        self,
        track_ids: Sequence[str],
        spec_fn: Callable[[str], np.ndarray],
        label_fn: Callable[[str], dict],
        max_length_diff: int = 1,
        pad_short_notes: bool = False,
        max_undershoot: int | None = None,
    ):
        self.track_ids = tuple(track_ids)
        self.tracks: list[Track] = []
        for tid in track_ids:
            spec = spec_fn(tid)
            label = label_fn(tid)
            notes = np.asarray(label["notes"], np.float32)
            spec, notes = reconcile_lengths(
                np.asarray(spec, np.float32), notes, max_length_diff,
                pad_short_notes=pad_short_notes,
                max_undershoot=max_undershoot,
            )
            self.tracks.append(
                Track(
                    track_id=tid,
                    spectrogram=_freeze(spec),
                    notes=_freeze(notes),
                    original_times=_freeze(np.asarray(label["original"]["times"])),
                    original_freqs=_freeze(np.asarray(label["original"]["freqs"])),
                )
            )

    def __len__(self) -> int:
        return len(self.tracks)

    def __getitem__(self, idx: int) -> Track:
        return self.tracks[idx]

    @property
    def num_frames_vector(self) -> np.ndarray:
        return np.asarray([t.num_frames for t in self.tracks], np.int64)

    def note_range_check(self, note_min: float, note_max: float) -> list[str]:
        """Returns warnings for out-of-range voiced notes (the reference
        logs them, dcnet/softmax_viterbi.py:547-563)."""
        warnings = []
        voiced = np.concatenate([t.notes[t.notes > 0] for t in self.tracks])
        if len(voiced):
            lo, hi = voiced.min(), voiced.max()
            if lo < note_min:
                warnings.append(f"note min {lo:.2f} below grid start {note_min:.2f}")
            if hi > note_max:
                warnings.append(f"note max {hi:.2f} above grid end {note_max:.2f}")
        return warnings
