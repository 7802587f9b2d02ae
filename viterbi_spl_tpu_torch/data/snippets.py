"""Snippet pipeline: whole tracks -> fixed-length model inputs (counterpart
of viterbi_spl_tpu/data/snippets.py; the same NumPy draws from the same
generator, so the port's training batches equal the JAX app's).

Re-design of the reference's tf.data + tf.py_function pipeline
(dcnet/softmax_viterbi.py:587-742): plain NumPy generators (the arrays are
already in memory; the device feed is one host-to-device copy per batch).

- gen_split_list      — [start, end) frame pairs per track (:565-575),
- training_snippets   — shuffled, repeating snippet stream (:640-650),
- inference_snippets  — ordered stream carrying (rec_idx, snippet_idx) so
                        metrics can reassemble tracks (:658-742),
- chunk_fixed         — fixed-size chunking with zero padding for the
                        batched families (jdc 31-frame/64-batch,
                        jdc/kum_m2m3.py:511-590; ftanet/tonet
                        128-frame/16-batch, ftanet/yu.py:470-551).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from .registry import TrackDataset


def gen_split_list(num_frames: int, snippet_len: int) -> list[tuple[int, int]]:
    splits = list(range(0, num_frames + 1, snippet_len))
    if splits[-1] != num_frames:
        splits.append(num_frames)
    return list(zip(splits[:-1], splits[1:]))


def snippet_index(dataset: TrackDataset, snippet_len: int) -> list[tuple[int, int, int]]:
    """All (rec_idx, start, end) triples over a dataset."""
    out = []
    for rec_idx, track in enumerate(dataset.tracks):
        for s, e in gen_split_list(track.num_frames, snippet_len):
            out.append((rec_idx, s, e))
    return out


def training_snippets(
    dataset: TrackDataset,
    snippet_len: int,
    rng: np.random.Generator,
) -> Iterator[dict]:
    """Infinite shuffled stream of dict(spectrogram, notes) snippets."""
    index = snippet_index(dataset, snippet_len)
    while True:
        order = rng.permutation(len(index))
        for i in order:
            rec_idx, s, e = index[i]
            track = dataset[rec_idx]
            yield dict(
                spectrogram=track.spectrogram[s:e],
                notes=track.notes[s:e],
            )


def inference_snippets(dataset: TrackDataset, snippet_len: int) -> Iterator[dict]:
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


def batched(iterator: Iterator[dict], batch_size: int, stack_keys: Sequence[str]):
    """Group a snippet stream into batches (lists for ragged fields,
    stacked arrays for `stack_keys`)."""
    batch: list[dict] = []
    for item in iterator:
        batch.append(item)
        if len(batch) == batch_size:
            yield _collate(batch, stack_keys)
            batch = []
    if batch:
        yield _collate(batch, stack_keys)


def _collate(batch: list[dict], stack_keys: Sequence[str]) -> dict:
    out: dict = {}
    for k in batch[0]:
        vals = [b[k] for b in batch]
        out[k] = np.stack(vals) if k in stack_keys else vals
    return out
