from .registry import Track
from .snippets import chunk_fixed, gen_split_list, inference_snippets
from .splits import (
    adc04_track_ids,
    medleydb_splits,
    mir1k_track_ids,
    mirex05_track_ids,
    rwc_track_ids,
)

__all__ = [
    "Track",
    "chunk_fixed",
    "gen_split_list",
    "inference_snippets",
    "medleydb_splits",
    "adc04_track_ids",
    "mirex05_track_ids",
    "mir1k_track_ids",
    "rwc_track_ids",
]
