from .mesh import Mesh, make_mesh
from .sharded_viterbi import (
    decode_tracks_sharded,
    viterbi_decode_time_sharded,
    viterbi_sharded_time_blocks,
)
from .tp import make_tp_mesh, tp_param_specs, tp_shard_tree, tp_spec

__all__ = [
    "Mesh",
    "make_mesh",
    "make_tp_mesh",
    "tp_spec",
    "tp_param_specs",
    "tp_shard_tree",
    "decode_tracks_sharded",
    "viterbi_decode_time_sharded",
    "viterbi_sharded_time_blocks",
]
