"""Family adapters: raw model outputs -> the decoding interface (counterpart
of viterbi_spl_tpu/models/adapters.py; NumPy in and out).

The Viterbi/metrics layer consumes pitch logits [T, n_bins] (+ optionally a
separate voicing logit). Each family gets there differently:

- dcnet: [T, 320] sigmoid logits, already in shape,
- msnet: [T, 321] softmax logits -> re-reference to the non-melody class
  (msnet/hsieh_m2m3.py:1895),
- ftanet/tonet: fixed-length chunk outputs -> reassemble -> re-reference
  (ftanet/viterbi_performance.py:2058),
- jdc: per-chunk dict(pitch [B, 31, 722], voicing [B, 31]) -> reassemble ->
  re-reference pitch (jdc/viterbi_softmax.py:2452-2453) + separate voicing
  logit; est notes map bins directly without interpolation
  (jdc/viterbi_softmax.py:2443-2470),
- imm: [U, N] log-energy logits -> transpose; the voicing threshold lives
  in the log-energy domain (imm/thresholding.py:80).
"""

from __future__ import annotations

import numpy as np

from ..hmm.obs import rereference_softmax_logits


def reassemble_chunks(chunks: np.ndarray, valid_frames: int) -> np.ndarray:
    """[N_chunks, chunk_len, ...] -> [valid_frames, ...] (undo chunk_fixed)."""
    c = np.asarray(chunks)
    return c.reshape(-1, *c.shape[2:])[:valid_frames]


def dcnet_pitch_logits(logits: np.ndarray) -> np.ndarray:
    out = np.asarray(logits, np.float32)
    if out.ndim == 3:  # [1, T, 320] whole-snippet batches
        out = out.reshape(-1, out.shape[-1])
    return out


def msnet_pitch_logits(logits_321: np.ndarray) -> np.ndarray:
    out = np.asarray(logits_321, np.float32)
    if out.ndim == 3:
        out = out.reshape(-1, out.shape[-1])
    return rereference_softmax_logits(out)


def ftanet_pitch_logits(chunk_logits: np.ndarray, valid_frames: int) -> np.ndarray:
    """[N, 128, 321] -> [T, 320] re-referenced."""
    flat = reassemble_chunks(chunk_logits, valid_frames)
    return rereference_softmax_logits(flat)


def tonet_pitch_logits(chunk_pitch: np.ndarray, valid_frames: int) -> np.ndarray:
    """[N, 361, 128] (class-major) -> [T, 360] re-referenced."""
    c = np.transpose(np.asarray(chunk_pitch), (0, 2, 1))  # [N, 128, 361]
    flat = reassemble_chunks(c, valid_frames)
    return rereference_softmax_logits(flat)


def jdc_outputs(
    chunk_pitch: np.ndarray, chunk_voicing: np.ndarray, valid_frames: int
) -> tuple[np.ndarray, np.ndarray]:
    """([N, 31, 722], [N, 31]) -> (pitch logits [T, 721] re-referenced,
    voicing logits [T])."""
    pitch = reassemble_chunks(chunk_pitch, valid_frames)
    voicing = reassemble_chunks(chunk_voicing[..., None], valid_frames)[:, 0]
    return rereference_softmax_logits(pitch), voicing


def imm_pitch_logits(log_energies_un: np.ndarray) -> np.ndarray:
    """[U, N] log10-energy logits -> [T=N, U] time-major."""
    return np.ascontiguousarray(np.asarray(log_energies_un, np.float32).T)


def jdc_est_notes(bins: np.ndarray, note_range: np.ndarray) -> np.ndarray:
    """Direct bin -> note mapping without interpolation
    (jdc/viterbi_softmax.py:2443-2470)."""
    return np.asarray(note_range)[np.minimum(bins, len(note_range) - 1)]
