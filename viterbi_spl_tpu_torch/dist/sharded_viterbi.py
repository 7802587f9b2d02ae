"""Multi-device Viterbi decoding over a device mesh (counterpart of
viterbi_spl_tpu/dist/sharded_viterbi.py).

Two parallelism seams:

1. `decode_tracks_sharded`: track-level data parallelism. A batch of tracks
   is split over the mesh's "data" devices, and each device decodes its
   share with the dense batched kernels (K3 -> argmax -> K4).

2. `viterbi_sharded_time_blocks`: sequence parallelism for one long track.
   The T axis is cut into blocks, one per device of the "seq" axis; each
   block gets an observation halo on both sides (a cyclic shift of the
   neighbouring blocks, as jax.lax.ppermute's), runs a cold-start forward
   DP through its left halo so that the max-plus carry forgets the unknown
   boundary, backtraces through its right halo so that the pointer chase
   likewise merges, and keeps only its own block. A seam flag per boundary
   certifies that adjacent blocks agreed across it, i.e. that the decode
   equals the single-track one there. Each block's forward and chase are
   the window kernels K7 and K8 (the JAX package's scan variant and its
   Pallas variant give the same states and flags, so one function stands
   for both); the blocks that share a device run as one K7 and one K8
   launch over their windows.

The mesh is a device list driven from one process (dist/mesh.py); on the
CPU every kernel is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hmm.viterbi import first_argmax
from ..hmm.viterbi_dense import (
    decode_over_data,
    dense_backtrace,
    dense_forward,
    viterbi_backtrace,
    viterbi_forward,
    window_backtrace,
    window_forward,
)
from ..utils import on_device
from .mesh import Mesh


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def decode_tracks_sharded(log_B, log_pi, log_obs_batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Decode a [N, T, S] batch of full-length tracks, N split over the
    "data" axis. Returns [N, T] int32 states on the batch's device."""
    N, T, _ = log_obs_batch.shape
    log_B, log_pi = _f32(log_B), _f32(log_pi)

    def local(x, lengths):
        t1_last, t1m1 = dense_forward(log_B, log_pi, x, lengths)
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        return dense_backtrace(log_B, t1m1, last, lengths)

    return decode_over_data(mesh, log_obs_batch, np.full(N, T, np.int32), local)


def _bp_row(log_B: torch.Tensor, t1_prev_row: torch.Tensor) -> torch.Tensor:
    """Backpointer row for a frame given T1 of the previous frame:
    bp[s] = first-argmax_{s'} (T1prev[s'] + log_B[s, s'])."""
    return first_argmax(t1_prev_row[None, :] + log_B, dim=1).to(torch.int32)


def halo_windows(log_obs: torch.Tensor, devices, H: int):
    """The windows of a [T, S] track cut into len(devices) blocks of L
    frames: block i's window, on devices[i], is [block i-1's last H rows |
    block i | block i+1's first H rows], with ppermute's cyclic wrap at both
    ends (the halo exchange). Returns (windows, lengths, reset rows): block
    0 starts exactly at its true frame 0 (window row H), the others start
    cold (-1); the last block ends at its true last frame (H + L rows), the
    others run through their right halo (H + L + H)."""
    n = len(devices)
    L = log_obs.shape[0] // n
    blocks = [log_obs[i * L:(i + 1) * L].to(d) for i, d in enumerate(devices)]
    windows = [
        torch.cat([blocks[(i - 1) % n][L - H:].to(d), blocks[i], blocks[(i + 1) % n][:H].to(d)])
        for i, d in enumerate(devices)
    ]
    lengths = [H + L if i == n - 1 else 2 * H + L for i in range(n)]
    resets = [H if i == 0 else -1 for i in range(n)]
    return windows, lengths, resets


def viterbi_sharded_time_blocks(log_B, log_pi, log_obs: torch.Tensor, mesh: Mesh, halo: int,
                                axis: str = "seq"):
    """Decode one [T, S] track with T cut into blocks over `axis` of
    `mesh`. T must divide evenly by the axis size, and 1 <= halo <= T / n.
    Returns (states [T] int32, seams_ok [n_blocks-1] bool), both on
    log_obs's device: seams_ok[i] certifies that block i+1's warm-up chase
    agreed with block i's decoded tail, i.e. the halo was long enough for
    the max-plus recursion to forget the block boundary."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    T = log_obs.shape[0]
    if T % n:
        raise ValueError(f"T={T} does not divide into {n} blocks")
    L, H = T // n, int(halo)
    if not 1 <= H <= L:
        raise ValueError(f"halo must be in [1, {L}], got {halo}")
    W = H + L + H
    log_B, log_pi = _f32(log_B), _f32(log_pi)
    windows, lengths, resets = halo_windows(log_obs, devices, H)

    groups: dict = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    states_win, cold_bp, warm_bp = [None] * n, [None] * n, [None] * n
    for dev, idx in groups.items():
        with on_device(dev):
            lens = [lengths[i] for i in idx]
            t1_last, t1m1 = window_forward(log_B, log_pi, torch.stack([windows[i] for i in idx]),
                                           lens, [resets[i] for i in idx])
            start = torch.argmax(t1_last, dim=1)  # first maximum, as jnp.argmax
            st = window_backtrace(log_B, t1m1, start, lens)
            lB = log_B.to(dev)
            for k, i in enumerate(idx):
                states_win[i] = st[k]
                cold_bp[i] = _bp_row(lB, t1m1[k, H])
                if i < n - 1:  # the last block's rows past H + L are unspecified
                    warm_bp[i] = _bp_row(lB, t1m1[k, H + L])

    # the certificate, two necessary conditions at each seam i (block i's
    # flag; block 0's is trivially true and dropped):
    # (a) block i-1's chase over its right halo equals block i's first H
    #     kept states;
    # (b) block i's backpointer row for its first frame, from its cold T1,
    #     equals the row block i-1 computes from its warm T1 for that frame.
    seams = []
    for i in range(1, n):
        dev = devices[i]
        overlap_ok = torch.equal(states_win[i - 1][H + L:W].to(dev), states_win[i][H:H + H])
        bp_ok = torch.equal(warm_bp[i - 1].to(dev), cold_bp[i])
        seams.append(overlap_ok and bp_ok)
    out = log_obs.device
    states = torch.cat([states_win[i][H:H + L].to(out) for i in range(n)])
    return states, torch.tensor(seams, dtype=torch.bool, device=out)


def viterbi_decode_time_sharded(log_B, log_pi, log_obs: torch.Tensor, mesh: Mesh,
                                halo: int = 64, max_halo: int = 4096, axis: str = "seq"):
    """Certified time-sharded decode: runs `viterbi_sharded_time_blocks`
    and doubles the halo until every seam certificate passes (while
    halo <= max_halo and halo < the block length), else falls back to the
    exact single-track decode (K7 -> K8 from frame 0 on the axis's first
    device).

    Returns (states [T] int32 on log_obs's device, final halo or -1 for
    the fallback)."""
    T = log_obs.shape[0]
    L = T // mesh.shape[axis]
    h = halo
    while h <= max_halo and h < L:
        states, seams = viterbi_sharded_time_blocks(log_B, log_pi, log_obs, mesh, halo=h, axis=axis)
        if bool(seams.all()):
            return states, h
        h *= 2
    dev = mesh.axis_devices(axis)[0]
    with on_device(dev):
        t1_last, t1m1 = viterbi_forward(log_B, log_pi, log_obs.to(dev), T)
        states = viterbi_backtrace(t1m1, log_B, torch.argmax(t1_last), T)
    return states.to(log_obs.device), -1
