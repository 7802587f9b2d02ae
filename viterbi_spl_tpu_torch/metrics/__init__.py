from .mel_eval import (
    evaluate_melody,
    hz_to_midi,
    midi_to_hz,
    resample_melody_series,
    to_cent_voicing,
)
from .melody import MelodyMetrics, est_notes_interp, frame_counts

__all__ = [
    "evaluate_melody",
    "hz_to_midi",
    "midi_to_hz",
    "resample_melody_series",
    "to_cent_voicing",
    "MelodyMetrics",
    "est_notes_interp",
    "frame_counts",
]
