"""Snippet pipeline: whole tracks -> fixed-length model inputs (counterpart of
viterbi_spl_tpu/data/snippets.py, its inference half: the training stream
waits for the training slice).

- gen_split_list      — [start, end) frame pairs per track
                        (dcnet/softmax_viterbi.py:565-575),
- inference_snippets  — ordered stream carrying (rec_idx, snippet_idx) so
                        metrics can reassemble tracks (:658-742),
- chunk_fixed         — fixed-size chunking with zero padding for the
                        batched families (jdc 31-frame/64-batch,
                        jdc/kum_m2m3.py:511-590; ftanet/tonet
                        128-frame/16-batch, ftanet/yu.py:470-551).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def gen_split_list(num_frames: int, snippet_len: int) -> list[tuple[int, int]]:
    splits = list(range(0, num_frames + 1, snippet_len))
    if splits[-1] != num_frames:
        splits.append(num_frames)
    return list(zip(splits[:-1], splits[1:]))


def inference_snippets(dataset, snippet_len: int) -> Iterator[dict]:
    """Ordered stream with (rec_idx, snippet_idx) bookkeeping."""
    for rec_idx, track in enumerate(dataset.tracks):
        for snippet_idx, (s, e) in enumerate(
            gen_split_list(track.num_frames, snippet_len)
        ):
            yield dict(
                rec_idx=rec_idx,
                snippet_idx=snippet_idx,
                num_snippets=len(gen_split_list(track.num_frames, snippet_len)),
                spectrogram=track.spectrogram[s:e],
                notes=track.notes[s:e],
            )


def chunk_fixed(
    spec: np.ndarray, notes: np.ndarray, chunk_len: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Split one track into zero-padded fixed-length chunks.

    Returns (spec_chunks [N, chunk_len, ...], note_chunks [N, chunk_len],
    valid_frames). Chunks concatenated and trimmed to valid_frames recover
    the track exactly.
    """
    T = len(spec)
    n = -(-T // chunk_len)
    pad = n * chunk_len - T
    spec_p = np.pad(spec, [(0, pad)] + [(0, 0)] * (spec.ndim - 1))
    notes_p = np.pad(notes, (0, pad))
    return (
        spec_p.reshape(n, chunk_len, *spec.shape[1:]),
        notes_p.reshape(n, chunk_len),
        T,
    )
