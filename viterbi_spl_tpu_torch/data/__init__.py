from .registry import Track
from .snippets import chunk_fixed, gen_split_list, inference_snippets

__all__ = ["Track", "chunk_fixed", "gen_split_list", "inference_snippets"]
