from .registry import Track, TrackDataset, dataset_roots
from .snippets import chunk_fixed, gen_split_list, inference_snippets, training_snippets
from .splits import (
    adc04_track_ids,
    medleydb_splits,
    mir1k_track_ids,
    mirex05_track_ids,
    rwc_track_ids,
)

__all__ = [
    "Track",
    "TrackDataset",
    "dataset_roots",
    "chunk_fixed",
    "gen_split_list",
    "inference_snippets",
    "training_snippets",
    "medleydb_splits",
    "adc04_track_ids",
    "mirex05_track_ids",
    "mir1k_track_ids",
    "rwc_track_ids",
]
