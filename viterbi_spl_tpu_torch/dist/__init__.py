from .mesh import Mesh, make_mesh
from .sharded_viterbi import (
    decode_tracks_sharded,
    viterbi_decode_time_sharded,
    viterbi_sharded_time_blocks,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "decode_tracks_sharded",
    "viterbi_decode_time_sharded",
    "viterbi_sharded_time_blocks",
]
