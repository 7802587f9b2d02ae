from .oracle import viterbi_oracle, viterbi_oracle_log
from .viterbi_dense import viterbi_decode_batch, viterbi_decode_batch_logobs

__all__ = [
    "viterbi_oracle",
    "viterbi_oracle_log",
    "viterbi_decode_batch",
    "viterbi_decode_batch_logobs",
]
