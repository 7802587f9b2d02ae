"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels from
csrc/, holds each against its plain PyTorch version and the NumPy oracle,
drives the decode service, its fused serving path, the transcription
paths (wav -> CFP -> TONet -> decode; wav -> NSGT -> DCNet -> decode; wav
-> STFT -> imm's NMF -> decode, and its --separate pass), the training
path (apps.tonet train -> checkpoint -> infer and sweep-obs) and the
real-data chains on a fake corpus (train -> infer --external-eval, the
native prefetch ring, imm's external corpora), mesh training and the
multi-process runtime (train over [cuda:0] * 4 meshes -> infer; two
processes under gloo) end to end through their entry points, and times
the kernels at full width.

    python3 chip_smoke.py [--baseline DIR]

--baseline DIR: a tree of an earlier commit of this repo (for example
`git archive f0acbee | tar -x -C runs/base`); its viterbi_spl_tpu_torch
package is imported as `vspl_baseline` and its csrc/viterbi_banded.cu,
viterbi_dense.cu, viterbi_window.cu and obs.cu built into its own build
directory (while this tree's kernels build), and phases 4, 4b and 4d time
its K1-K6 and K9 wrappers, and phase 4c its K7, in turns with this tree's
(old, new, new, old) as *_base_ms keys, each checked bit-equal to this
tree's output on the same inputs (states equal for K2/K4, log
observations bit-equal for K5/K6). Without it those keys are null.

Phases (one JSON line each):
  1. device: nvidia-smi name and power limit, torch/CUDA versions, build time.
  2. kernels against their plain versions on the card (N=16, T<=1024,
     ragged lengths): K1/K2 at 361 states (tonet, d_max 14) and 722 (jdc,
     d_max 40), K3/K4 at 722 (imm's analytic matrix) and 361 (a random
     dense matrix); exact equality (tolerance 0), and track 0 against the
     oracle; K1 by its rule's layout and by one block a track, K3 by both
     its routes (K7's kernel, the cluster kernel), K4 by its rule's
     segments, as one chain a track and in 7-frame segments with no
     warm-up (its seams re-chase); K2 by both its routes (the backpointer pass and the chase, and
     a chain per track), also on the tie fixture (hmm/fixtures.py:
     equal maxima at every step of every chase), equal to its plain version
     and to the fixture's path. K5/K6 at 361 bins (spw 5) and 722 (spw 16 and 20) under the
     observation contract (lanes at log TINY bit-equal, rtol 2e-4 with atol
     1e-6 above -80, at most log 2 in the floor region, the unvoiced lane
     within rtol 1e-6, plus (p + 1) 2^-24 for the softmax models, p the
     terms of the frame's softmax denominator); K9 at tonet 361 and jdc 722 for all three methods,
     bit-equal to K5/K6 -> K1, within the observations' summed error of its
     plain version, and K9 -> K2's track 0 against the oracle. K7/K8 over 8
     ragged windows in one launch each, with reset rows 0, -1 and 64, at
     361 states (bench.py's tonet matrix, taken dense) and 722 (imm's),
     exactly; each window with reset row 0 against the oracle.
  3. the main path: tonet artifacts from synthetic note tracks, 8 logit
     files, the decode CLI on its default device for all three methods
     (exactly K1/K2 must launch), then a DecoderSetup with imm's analytic
     matrix (exactly K3/K4); track 0 against the oracle each time. After the
     launch counts are read, each kernel against its plain version again,
     exactly, on the log observations of those two batches.
  3b. the fused serving path, its counts set to 0 just before its entry
     points and read just after them: the CLI with --fused-obs for all
     three methods (K5 or K6 -> K1/K2), an imm DecoderSetup(fused_obs=True)
     (K5 -> K3/K4), and viterbi_decode_batch_fused_obs on the CLI batch
     (K9 -> K2), each call required to launch exactly those kernels. Then
     each path's melody lines equal the default path's, track 0 equals the
     oracle on the port's own fused log observations, and K5, K6 and K9
     hold against their plain versions on those inputs.
  3e. (after the sequence-parallel path, 3c) the transcription path, its
     counts set to 0 just before and read just after: 8 synthetic 60 s
     wavs at 8 kHz (a harmonic tone on a seeded melody walk, plus noise),
     a full-width TONet checkpoint from a seeded torch init (360 bins,
     mode "all", the ftanet backbone, attn_dim 2048, 128-frame snippets),
     tonet artifacts from seeded note tracks; after a warm-up on track 0,
     cli.transcribe.main with --batch 16 --method shaun (K1/K2) and with --fused-obs (K5 -> K1/K2),
     then the card's logits through viterbi_decode_batch_fused_obs (K9 ->
     K2). Then: the three give the same states, track 0 (6,000 frames)
     equals the oracle on the card's logits, ms per stage (wav load, CFP,
     model, observation + decode) and frames/s, the TF32 settings; the CFP
     features and the model's logits on the card against the CPU's
     (FEATURE_TOL, LOGIT_TOL) on a 15.36 s excerpt for TONet and one 20 s
     track for ftanet, msnet and jdc at full width.
  3f. (after 3e) the 44.1 kHz paths, each call's counts set to 0 just before
     it and read just after, each call required to launch exactly its
     kernels. dcnet: 4 synthetic 60 s wavs at 44.1 kHz (write_melody_wav),
     a DCNet checkpoint at its published widths (seeded torch init, its
     BatchNorm statistics measured on a synthetic track's features),
     dcnet artifacts from seeded note tracks;
     after a warm-up on track 0, cli.transcribe.main --batch 16 --method
     shaun (K1/K2), with --fused-obs (K5 -> K1/K2), and the card's logits
     through viterbi_decode_batch_fused_obs (K9 -> K2); the three give the
     same states, track 0 equals the oracle; ms per stage (wav load, NSGT,
     model load, model, decode), track 0's front-end in parts, and frames/s; after the counts, K1/K2 (by
     every layout and route), K5 and K9 against their plain versions on the
     path's inputs (as phase 2); the NSGT feature and DCNet's
     logits on the card against the CPU's on a 20 s excerpt (FEATURE_TOL,
     LOGIT_TOL). imm at the full IMMConfig(): 2 synthetic 30 s wavs, after
     a warm-up on track 0, --family imm (K3/K4) and --fused-obs (K5 ->
     K3/K4), the same states, track 0 equal to the oracle on the card's
     logits, K3/K4 (every route) and K5 against their plain versions on the
     path's inputs; the sweeps each fit ran, ms per sweep, ms per stage (wav load,
     STFT, NMF fit, energies, decode), frames/s; --separate on one stereo
     20 s wav (exactly one K3 and one K4), melody + accompaniment within
     SEPARATE_BOUND of the mix per channel; on a 5 s excerpt the card's
     power spectrogram against the CPU's (IMM_SX_TOL), and both fits from
     the CPU's spectrogram and the same draws: the same sweeps, logits
     within IMM_LOGIT_ATOL.
  3g. (after 3f) the training path at TONet's published width (360 bins,
     attn_dim 2048, mode "all", the ftanet backbone, 128-frame chunks,
     batch 4): apps.tonet.main train --synthetic for 2 epochs of 20 steps
     with a checkpoint and --log-dir; then, each call's counts set to 0
     just before it and read just after, infer (exactly K1/K2) and
     sweep-obs (K1/K2) on that checkpoint. Every epoch's loss finite, one
     train_oa event an epoch, the checkpoint read by restore_checkpoint and
     by cli/transcribe's loader, the first test track's states equal to the
     oracle's. Then 3 steps from the same weights and batches, dropout off,
     on the card and on the CPU (losses, the first step's gradient and
     BatchNorm averages within TRAIN_* bounds; later steps' averages and the
     parameter drift printed), and the times: ms per train step (median of 5 after 2
     warm-up steps, CUDA events), training frames/s, ms per validation, ms
     per checkpoint save, infer ms, peak memory, each printed beside the
     card's name and power limit.
  3h. (after 3g) the real-data chains on a fake corpus (data/fake_corpus.py:
     10 s tracks, its CFPs on the card), its roots in the environment, each
     counted call's counts set to 0 just before it and read just after.
     TONet at its published width: train --debug (10 steps on the fake
     MedleyDB: wav -> CFP on the card -> model -> loss), then infer --debug
     --external-eval (exactly K1/K2): validation, test, adc04, mirex05,
     mir1k and rwc, finite raw and Viterbi OAs, cross_check_diff_viterbi
     within 0.05; adc04's first track decoded on the card and on the CPU to
     the same states, equal to the oracle's; the train step on the
     real-data batches with and without the native prefetch ring (CUDA
     events, and the host's wall time with the batch drawn); the ring's
     batches equal to python_reference_batches, byte for byte. msnet: train
     --native-prefetch one step through the ring, infer --external-eval
     (exactly K1/K2), the cross-check within 1e-6 on validation, test and
     adc04. imm: eval --debug --external-eval --original with the full
     IMMConfig() (its viterbi method on the banded kernels K1/K2, its
     original method on K3/K4), finite OAs of the three methods on adc04,
     mirex05 and mir1k, no rwc, the fits' ms a corpus. The native CPU
     decoder's frames/s on the host (361 states), equal to the oracle.
     Times printed beside the card's name and power limit.
  3i. (after 3h) mesh training and the multi-process runtime
     (phase_mesh_train): TONet at its published width (3g's configuration,
     batch 4 x 128 frames), 1 epoch of 3 steps through apps.common._train
     on the card, then over meshes of [cuda:0] * 4 with data=4 and
     data=2,model=2 (BatchNorm on the global batch's statistics, the
     global dropout masks; with model=2 params, Adam's moments and the
     averages split by the tp rule): each step's loss against the single
     run's (the first within MESH_FIRST_RTOL, later ones within
     MESH_LOSS_RTOL), the BatchNorm averages after step 1, the sharded
     leaves; the data=2,model=2 checkpoint in the single-device layout,
     restored by infer with no mesh (counts set to 0 just before: exactly
     K1/K2). Two processes on cuda:0 joined by initialize_distributed
     (gloo): the all-reduce, decode_tracks_sharded (K3 and K4 twice in each
     process, its tracks equal to the oracle's), tp training with the
     barriered checkpoint and resume within the Adam bound, BatchNorm
     across the processes. ms per step single and on each mesh, the mesh's
     gradient reduction and gather ms, beside the card's name and power
     limit.
  4. timed decode at full width: N=128 x T=32768 at 361 states (banded),
     N=64 x T=4096 at 722 (banded), N=16 x T=4096 at 361 and 722 (dense,
     with K4's segment length and the frames its seams re-chased); with
     --baseline, the earlier K1/K2 in turns at the banded shapes and the
     earlier K3/K4 at the dense ones.
  4b. bench.py's two serving chains: 361 states, N=128, T=8192, spw 5;
     722 states, N=64, T=4096, spw 16, d_max 40, track 0 at length 1024.
     ms and frames/s of K5 alone, K6 (scaled) alone, K5 -> K1 -> argmax ->
     K2, K9 -> K2, and the default path (the PyTorch observation model, the
     log, then K1/K2); track 0 against the oracle on K5's log observations;
     with --baseline, the earlier K1, K2, K5, K6 and K9 in turns.
  4c. the single-track kernels: K7 and K8 alone (us per frame and per step,
     K7's cluster size) and the single-track decode on the 32768-frame
     tonet track, the time-sharded decode's ms per halo attempt against it,
     and the single-track decode at imm 722, T=4096.
  4d. each kernel at the shapes of the launches the kernels line counts,
     one timing per counted launch: K1/K2 on the CLI's batch, K3/K4 on the
     imm DecoderSetup's, K5/K6 on the fused CLI's and DecoderSetup's logits,
     K9 on the fused decode API's batch, K7/K8 over the time-sharded
     decode's windows at each halo it tried and the seam-stress fixture's;
     the sum of those times and of their bounds; with --baseline, the
     earlier K1-K6 and K9 in turns at the same launches, and their sums.
  5. the kernels line: per kernel its launches on the main path, error
     against its plain version, time, plain-version time, bound and what
     bounds it (and the phase 4d sums), with its launches on the fused,
     transcription (3e), 44.1 kHz (3f: dcnet, imm with --separate),
     training (3g: infer, sweep-obs), real-data (3h: tonet and msnet
     infer --external-eval, imm eval --external-eval) and mesh (3i: infer
     on the mesh checkpoint, the two-process decode) paths.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero and prints no result; it also exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import platform
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

import viterbi_spl_tpu_torch
from viterbi_spl_tpu_torch import cuda_lib
from viterbi_spl_tpu_torch.cli import decode as cli_decode
from viterbi_spl_tpu_torch.cli.hmm_artifacts import (
    build_hmm_artifacts,
    quantize_tracks_for_family,
)
from viterbi_spl_tpu_torch.dist import (
    decode_tracks_sharded,
    make_mesh,
    viterbi_decode_time_sharded,
    viterbi_sharded_time_blocks,
)
from viterbi_spl_tpu_torch.dist.certify import make_seam_stress_hmm
from viterbi_spl_tpu_torch.dist.sharded_viterbi import halo_windows
from viterbi_spl_tpu_torch.families import family_spec
from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup
from viterbi_spl_tpu_torch.hmm import obs_fused as OF
from viterbi_spl_tpu_torch.hmm import fixtures as FX
from viterbi_spl_tpu_torch.hmm import params as hmm_params
from viterbi_spl_tpu_torch.hmm import viterbi_banded as VB
from viterbi_spl_tpu_torch.hmm import viterbi_dense as VD
from viterbi_spl_tpu_torch.hmm.obs import shaun_observation_probs
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.streaming import StreamingViterbiBatch
from viterbi_spl_tpu_torch.hmm.viterbi import log_obs_fn, prepare_log_params

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 outside the
# tensor cores (max-plus DP has no tensor-core form)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")
KERNEL_INFO = {
    "K1": ("banded_forward", "viterbi_spl_tpu_torch/csrc/viterbi_banded.cu",
           "viterbi_spl_tpu/hmm/viterbi_banded.py:467"),
    "K2": ("banded_backtrace", "viterbi_spl_tpu_torch/csrc/viterbi_banded.cu",
           "viterbi_spl_tpu/hmm/viterbi_banded.py:773"),
    "K3": ("dense_forward", "viterbi_spl_tpu_torch/csrc/viterbi_window.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:507"),
    "K4": ("dense_backtrace", "viterbi_spl_tpu_torch/csrc/viterbi_dense.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:558"),
    "K5": ("shaun_log_obs", "viterbi_spl_tpu_torch/csrc/obs.cu",
           "viterbi_spl_tpu/hmm/obs_pallas.py:320"),
    "K6": ("softmax_log_obs", "viterbi_spl_tpu_torch/csrc/obs.cu",
           "viterbi_spl_tpu/hmm/obs_pallas.py:239"),
    "K7": ("window_forward", "viterbi_spl_tpu_torch/csrc/viterbi_window.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:238"),
    "K8": ("window_backtrace", "viterbi_spl_tpu_torch/csrc/viterbi_window.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:303"),
    "K9": ("banded_forward_obs", "viterbi_spl_tpu_torch/csrc/viterbi_banded.cu",
           "viterbi_spl_tpu/hmm/viterbi_banded.py:467"),
}


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def counted(fn, *args, **kwargs):
    """(fn(*args, **kwargs), {kernel id: launches it made, where any})."""
    before = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    out = fn(*args, **kwargs)
    made = {k: w.launches - before[k] for k, w in VD.KERNEL_WRAPPERS.items()}
    return out, {k: n for k, n in made.items() if n}


def run_counted(expect, what: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), failing unless the kernels it launched are
    exactly those in expect (a path that silently took another route
    launches others, or none): a set of kernel ids, or a dict of kernel id
    to its exact number of launches."""
    out, made = counted(fn, *args, **kwargs)
    got = made if isinstance(expect, dict) else set(made)
    check(got == expect, f"{what} launched {made}, expected {expect}")
    return out


def shaped_matrix(n_bins: int, d_max: int, seed: int):
    """A shaped (banded + switch-coupled) melody HMM from a synthetic pitch
    walk, through the port's parameter pipeline (bench.py's construction)."""
    rng = np.random.default_rng(seed)
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 5000)), 0, n_bins - 1)]
    stats = hmm_params.count_statistics(walk, n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]),
        n_bins, d_max, floor=2,
    )
    return A, hmm_params.shape_init_probs(stats.p_steady, p_th=1e-4)


def dense_matrix(S: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.random((S, S)).astype(np.float32) ** 4
    A /= A.sum(axis=1, keepdims=True)
    return A, np.full(S, 1.0 / S)


def uniform_log_obs(N, T, S, seed, dev):
    """Log observations uniform in [-20, 0), made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)


def cuda_ms(fn, iters: int) -> float:
    """Median ms of fn() over iters back-to-back launches after one warm-up:
    a CUDA event between consecutive launches times each one, so a one-off
    stall (an allocation, a neighbour on the host) moves no reading."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))


def kernel_pair(kind, A, pi, log_obs, lengths):
    """(forward, backtrace) closures of the banded or dense kernels for
    one matrix, and the matching plain versions."""
    log_B, log_pi = prepare_log_params(A, pi)
    if kind == "banded":
        bs = VB.extract_banded_structure(A)
        check(bs is not None, "shaped matrix has the banded structure")
        fwd = lambda o, L, route=None: VB.banded_forward(bs, log_pi, o, L, cluster=route)  # noqa: E731
        bt = lambda t1m1, last, L, route=None: VB.banded_backtrace(bs, t1m1, last, L, route)  # noqa: E731
        fwd_p = lambda o, L: VB.banded_forward_plain(bs, torch.from_numpy(log_pi).to(o.device), o, L)  # noqa: E731
        bt_p = lambda t1m1, last, L: VB.banded_backtrace_plain(bs, t1m1, last, L)  # noqa: E731
    else:
        check(VB.extract_banded_structure(A) is None, "dense matrix has no banded structure")
        dev = log_obs.device
        lB, lpi = torch.from_numpy(log_B).to(dev), torch.from_numpy(log_pi).to(dev)
        # the tables on the card, so that no timing includes their upload
        fwd = lambda o, L, route=None: VD.dense_forward(lB, lpi, o, L, route=route)  # noqa: E731
        bt = lambda t1m1, last, L, route=None: VD.dense_backtrace(  # noqa: E731
            lB, t1m1, last, L, **K4_VARIANTS[route])
        fwd_p = lambda o, L: VD.dense_forward_plain(lB, lpi, o, L)  # noqa: E731
        bt_p = lambda t1m1, last, L: VD.dense_backtrace_plain(lB, t1m1, last, L)  # noqa: E731
    return (fwd, bt, fwd_p, bt_p), log_B, log_pi


# K4's variants held against its plain version: its rule's segments, one
# chain a track, and segments of 7 frames with no warm-up (the seams re-chase)
K4_VARIANTS = {None: {}, "chain": {"segment": 1 << 30}, "seams": {"segment": 7, "warmup": 0}}


def k2_routes(kind):
    """The backtrace's routes to hold against its plain version: K2's two
    (banded_backtrace's route), or K4's variants (K4_VARIANTS)."""
    return ("pass", "chain") if kind == "banded" else tuple(K4_VARIANTS)


def forward_routes(kind):
    """The forward's layouts or routes to hold against its plain version:
    K1 by its rule (k1_cluster) and by one block a track (cluster 0); K3 by
    K7's kernel (its rule's tracks a cluster) and by its cluster kernel."""
    return (None, 0) if kind == "banded" else ("window", "cluster")


def compare_kernels(kind, A, pi, log_obs, lengths):
    """One matrix's forward and backtrace kernels against their plain
    versions on the same inputs, each by every layout or route it has:
    (forward error, backtrace error, track 0 equals the oracle by every
    route). The errors are the largest absolute differences of t1_last, of
    t1m1 up to each track's length and of the states."""
    (fwd, bt, fwd_p, bt_p), log_B, log_pi = kernel_pair(kind, A, pi, log_obs, lengths)
    fwds = [fwd(log_obs, lengths, route) for route in forward_routes(kind)]
    t1m1_k = fwds[0][1]
    t1_p, t1m1_p = fwd_p(log_obs, lengths)
    last = torch.argmax(t1_p, dim=1).to(torch.int32)
    st_ks = [bt(t1m1_k, last, lengths, route) for route in k2_routes(kind)]
    st_p = bt_p(t1m1_p, last, lengths)
    torch.cuda.synchronize()
    f_err = max(float((t1_k - t1_p).abs().max()) for t1_k, _ in fwds)
    b_err = 0.0
    for n, L in enumerate(lengths):
        L = int(L)
        for _, rows_k in fwds:
            f_err = max(f_err, float((rows_k[n, :L] - t1m1_p[n, :L]).abs().max()))
        for st_k in st_ks:
            b_err = max(b_err, float((st_k[n, :L] - st_p[n, :L]).abs().max()))
    L0 = int(lengths[0])
    oracle = viterbi_oracle_log(log_B, log_pi, log_obs[0, :L0].cpu().numpy())
    return f_err, b_err, all(np.array_equal(st_k[0, :L0].cpu().numpy(), oracle) for st_k in st_ks)


def record_errors(errs, kind, label, N, T, f_err, b_err, oracle_ok) -> None:
    """Emit one equality line, fold it into errs, and fail unless exact."""
    kf, kb = ("K1", "K2") if kind == "banded" else ("K3", "K4")
    errs[kf] = max(errs[kf], f_err)
    errs[kb] = max(errs[kb], b_err)
    emit({"phase": "equality", "kind": kind, "shape": label, "N": N, "T": T,
          "forward_routes": forward_routes(kind), "backtrace_routes": k2_routes(kind),
          "forward_max_abs_err": f_err,
          "backtrace_max_abs_err": b_err, "track0_matches_oracle": oracle_ok})
    check(f_err == 0.0 and b_err == 0.0, f"{kind} {label}: kernels equal their plain versions")
    check(oracle_ok, f"{kind} {label}: track 0 equals the oracle")


def phase_equality(dev, errs) -> None:
    """Kernels against plain versions and the oracle at N=16, T=1024 with
    ragged lengths; folds the largest absolute difference per kernel id
    into errs."""
    rng = np.random.default_rng(1)
    cases = [
        ("banded", 361, shaped_matrix(360, hmm_params.single_side_d_max(0.01, 60), 0)),
        ("banded", 722, shaped_matrix(721, 40, 1)),
        ("dense", 722, (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))),
        ("dense", 361, dense_matrix(361, 2)),
    ]
    N, T = 16, 1024
    for kind, S, (A, pi) in cases:
        lengths = rng.integers(T // 4, T + 1, N).astype(np.int32)
        lengths[0], lengths[1] = T, 1
        log_obs = uniform_log_obs(N, T, S, seed=S, dev=dev)
        record_errors(errs, kind, str(S), N, T, *compare_kernels(kind, A, pi, log_obs, lengths))
        if kind == "banded":
            # K2 by both routes on the tie fixture: two equal maxima at every
            # step of each chase
            bs = VB.extract_banded_structure(A)
            t1m1, last, path = FX.tie_fixture(bs, rng, lengths, T)
            t1m1 = torch.from_numpy(t1m1).to(dev)
            st_p = VB.banded_backtrace_plain(bs, t1m1, last, lengths)
            for route in k2_routes(kind):
                st_k = VB.banded_backtrace(bs, t1m1, torch.from_numpy(last).to(dev), lengths,
                                           route)
                err, on_path = 0.0, True
                for n, L in enumerate(lengths):
                    err = max(err, float((st_k[n, :L] - st_p[n, :L]).abs().max()))
                    on_path = on_path and np.array_equal(st_k[n, :L].cpu().numpy(), path[n, :L])
                errs["K2"] = max(errs["K2"], err)
                emit({"phase": "equality", "kind": "banded tie fixture", "shape": str(S),
                      "N": N, "T": T, "route": route, "backtrace_max_abs_err": err,
                      "states_equal_fixture_path": on_path})
                check(err == 0.0 and on_path,
                      f"K2 {S} tie fixture by its {route}: equals its plain version and the path")


def padded_log_obs(setup, logits_list):
    """The [N, T_max, S] log observations and the lengths that
    DecoderSetup.decode_batch hands the kernels for these tracks."""
    obs = [setup.observation_probs(lg) for lg in logits_list]
    lengths = np.array([o.shape[0] for o in obs], np.int32)
    batch = torch.zeros((len(obs), int(lengths.max()), obs[0].shape[1]), device=setup.device)
    for i, o in enumerate(obs):
        batch[i, : lengths[i]] = o
    return log_obs_fn(batch), lengths


def phase_main_path(dev, errs, tmp: Path) -> tuple[dict, dict]:
    """The decode service through its entry points, its counts set to 0
    just before; returns the launches of each kernel in this run and what
    the fused path compares with (inputs, artifacts, melody lines). Then
    holds each kernel against its plain version at the shapes the main path
    gave it, folding the errors into errs."""
    rng = np.random.default_rng(3)
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    spec = family_spec("tonet")
    # synthetic note tracks (MIDI, 0 = unvoiced) -> quantized -> artifacts
    notes = []
    for _ in range(4):
        walk = 60.0 + np.cumsum(rng.integers(-2, 3, 4000)) / 5.0
        voiced = np.repeat(rng.random(200) > 0.25, 20)
        notes.append(np.where(voiced, np.clip(walk, 40.0, 90.0), 0.0))
    build_hmm_artifacts(quantize_tracks_for_family(notes, spec), spec, tmp / "hmm")
    paths = []
    for i, T in enumerate(np.linspace(2000, 8000, 8).astype(int)):
        logits = rng.normal(-2.0, 1.0, (T, spec.n_bins)).astype(np.float32)
        line = np.clip(180 + np.cumsum(rng.integers(-1, 2, T)), 0, spec.n_bins - 1)
        logits[np.arange(T), line] += 6.0
        paths.append(tmp / f"track{i}.npy")
        np.save(paths[-1], logits)
    frames = 0
    cli_recs, cli_setups = {}, {}
    t0 = time.perf_counter()
    for method in METHODS:
        out = tmp / method
        recs = run_counted({"K1", "K2"}, f"CLI {method}", cli_decode.main,
            [str(p) for p in paths]
            + ["--family", "tonet", "--artifacts", str(tmp / "hmm"),
               "--out", str(out), "--method", method, "--format", "txt"]
        )
        for p, rec in zip(paths, recs):
            n_lines = len((out / f"{p.stem}.txt").read_text().splitlines())
            check(n_lines == len(rec["voiced"]) == np.load(p).shape[0],
                  f"{method}: {p.stem}.txt has one line per frame")
            frames += n_lines
        # track 0 against the oracle on the same log observations
        setup = cli_decode.build_setup(type("Args", (), dict(
            family="tonet", artifacts=str(tmp / "hmm"), threshold=None,
            method=method))())
        check(setup.device.type == "cuda", "the CLI's default device is cuda")
        log_obs = log_obs_fn(setup.observation_probs(np.load(paths[0]))).cpu().numpy()
        log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
        states = np.where(recs[0]["voiced"], recs[0]["bins"], spec.n_bins)
        check(np.array_equal(states, viterbi_oracle_log(log_B, log_pi, log_obs)),
              f"{method}: CLI track 0 equals the oracle")
        cli_recs[method], cli_setups[method] = recs, setup
    cli_s = time.perf_counter() - t0
    banded = {k: VD.KERNEL_WRAPPERS[k].launches for k in ("K1", "K2")}
    check(banded["K1"] >= 3 and banded["K2"] >= 3, f"CLI ran K1/K2: {banded}")
    cli_setup, cli_logits = setup, [np.load(p) for p in paths]

    # the dense path: imm's analytic matrix through DecoderSetup
    imm = family_spec("imm")
    setup = DecoderSetup(
        transition_matrix=hmm_params.imm_transition_matrix(20, imm.n_bins),
        init_probs=np.full(imm.n_bins + 1, 1.0 / (imm.n_bins + 1)),
        n_bins=imm.n_bins, note_min=imm.note_min,
        bins_per_semitone=imm.bins_per_semitone, spw=imm.spw,
        voicing_threshold=imm.voicing_threshold, hop_seconds=imm.hop_seconds,
        threshold_is_logit=True,
    )
    logits = []
    for T in (1500, 700, 1100, 500):
        lg = rng.normal(0.0, 1.0, (T, imm.n_bins)).astype(np.float32)
        line = np.clip(360 + np.cumsum(rng.integers(-3, 4, T)), 0, imm.n_bins - 1)
        lg[np.arange(T), line] += 5.0
        logits.append(lg)
    imm_lines = run_counted({"K3", "K4"}, "imm DecoderSetup", setup.decode_batch, logits)
    voiced, bins = imm_lines[0]
    log_obs = log_obs_fn(setup.observation_probs(logits[0])).cpu().numpy()
    log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
    check(np.array_equal(np.where(voiced, bins, imm.n_bins),
                         viterbi_oracle_log(log_B, log_pi, log_obs)),
          "imm DecoderSetup track 0 equals the oracle")
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    emit({"phase": "main_path", "cli_tracks": len(paths), "cli_methods": list(METHODS),
          "cli_frames": frames, "cli_seconds": cli_s, "imm_tracks": len(logits),
          "launches": launches})
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")),
          f"every kernel of the decode service ran on the main path: {launches}")

    # the kernels against their plain versions on the main path's inputs
    # (after the counts are read: these launches do not count)
    for kind, label, st, lgs in (("banded", "main path tonet 361", cli_setup, cli_logits),
                                 ("dense", "main path imm 722", setup, logits)):
        log_obs, lengths = padded_log_obs(st, lgs)
        record_errors(errs, kind, label, len(lengths), log_obs.shape[1], *compare_kernels(
            kind, st.transition_matrix, st.init_probs, log_obs, lengths))
    ctx = dict(paths=paths, hmm=tmp / "hmm", cli_recs=cli_recs, cli_setups=cli_setups,
               cli_logits=cli_logits, imm_setup=setup, imm_logits=logits, imm_lines=imm_lines)
    return launches, ctx


# ----------------------------------------------------------------------
# The fused serving path: K5, K6 and K9.
# ----------------------------------------------------------------------


def obs_logits(rng, N, T, n_bins, dev):
    """OF.contract_logits on the card."""
    return torch.from_numpy(OF.contract_logits(rng, N, T, n_bins)).to(dev)


def obs_cfg(method, spw, threshold, init_probs) -> dict:
    return dict(method=method, spw=spw, threshold_logit=threshold, init_probs=init_probs)


def check_obs(got, want, obs, label) -> float:
    """K5/K6 output against the plain version under the observation
    contract of the obs dict's model; returns the largest absolute
    difference."""
    res = OF.obs_contract(got.cpu().numpy(), want.cpu().numpy(),
                          softmax=obs["method"] != "shaun")
    emit({"phase": "obs_equality", "shape": label, **res})
    check(res["ok"], f"{label}: the observation kernel meets its contract against its plain version")
    return res["max_abs_err"]


def compare_k9(A, pi, logits, lengths, obs, label, errs) -> None:
    """K9 against K5/K6 -> K1 (bit for bit) and against its plain version:
    each T1 of the plain version differs by at most the summed largest
    observation errors of the frames so far plus one rounding of the T1
    magnitude per frame (max-plus steps move no error up); then K9 -> K2's
    track 0 against the oracle on K5/K6's log observations."""
    bs = VB.extract_banded_structure(A)
    log_B, log_pi = prepare_log_params(A, pi)
    t1_9, m_9 = VB.banded_forward_obs(bs, log_pi, logits, lengths, obs)
    log_obs = OF.log_obs(logits, obs)
    t1_1, m_1 = VB.banded_forward(bs, log_pi, log_obs, lengths)
    t1_p, m_p = VB.banded_forward_obs_plain(bs, log_pi, logits, lengths, obs)
    d_obs = (log_obs - OF.log_obs_plain(logits, obs)).abs().amax(dim=2)  # [N, T]
    exact = float((t1_9 - t1_1).abs().max())
    plain_err, ok = float((t1_9 - t1_p).abs().max()), True
    for n, L in enumerate(lengths):
        L = int(L)
        exact = max(exact, float((m_9[n, :L] - m_1[n, :L]).abs().max()))
        plain_err = max(plain_err, float((m_9[n, :L] - m_p[n, :L]).abs().max()))
        mag = float(t1_p[n].abs().max())
        allow = float(d_obs[n, :L].sum()) + L * float(np.spacing(np.float32(mag)))
        ok = ok and float((t1_9[n] - t1_p[n]).abs().max()) <= allow
    last = torch.argmax(t1_9, dim=1).to(torch.int32)
    states = VB.banded_backtrace(bs, m_9, last, lengths)
    L0 = int(lengths[0])
    oracle_ok = bool(np.array_equal(
        states[0, :L0].cpu().numpy(),
        viterbi_oracle_log(log_B, log_pi, log_obs[0, :L0].cpu().numpy())))
    errs["K9"] = max(errs["K9"], plain_err)
    errs["K9_vs_K5K6_K1"] = max(errs["K9_vs_K5K6_K1"], exact)
    emit({"phase": "k9_equality", "shape": label, "method": obs["method"],
          "N": logits.shape[0], "T": logits.shape[1],
          "max_abs_err_vs_k5k6_k1": exact, "max_abs_err_vs_plain": plain_err,
          "within_obs_error_bound": ok, "track0_matches_oracle": oracle_ok})
    check(exact == 0.0, f"K9 {label} {obs['method']}: bit-equal to K5/K6 -> K1")
    check(ok, f"K9 {label} {obs['method']}: within the observation error of its plain version")
    check(oracle_ok, f"K9 {label} {obs['method']}: K9 -> K2 track 0 equals the oracle")


def phase_obs_equality(dev, errs) -> None:
    """K5/K6 at 361 bins (spw 5) and 722 (spw 16, 20); K9 at tonet 361 and
    jdc 722 for all three methods, with ragged lengths."""
    rng = np.random.default_rng(5)
    N, T = 16, 1024
    for n_bins, spw in ((360, 5), (721, 16), (721, 20)):
        lg = obs_logits(rng, N, T, n_bins, dev)
        pri = rng.random(n_bins + 1).astype(np.float32) + 0.1
        for method in METHODS:
            obs = obs_cfg(method, spw, 0.3, pri / pri.sum())
            err = check_obs(OF.log_obs(lg, obs), OF.log_obs_plain(lg, obs), obs,
                            f"{method} {n_bins + 1} spw {spw} N={N} T={T}")
            k = "K5" if method == "shaun" else "K6"
            errs[k] = max(errs[k], err)
    for label, n_bins, d_max, spw in (("tonet 361", 360, 14, 5), ("jdc 722", 721, 40, 16)):
        A, pi = shaped_matrix(n_bins, d_max, n_bins)
        lengths = rng.integers(T // 4, T + 1, N).astype(np.int32)
        lengths[0], lengths[1] = T, 1
        lg = obs_logits(rng, N, T, n_bins, dev)
        # the matrix's own pi has an unvoiced prior of 0 (its walk is all
        # voiced): the scaled model divides by the priors, so take others
        pri = rng.random(n_bins + 1).astype(np.float32) + 0.1
        for method in METHODS:
            compare_k9(A, pi, lg, lengths, obs_cfg(method, spw, 0.3, pri / pri.sum()), label, errs)


def phase_fused_path(dev, errs, ctx) -> dict:
    """The fused serving path through its entry points, the counts set to
    0 just before them and read just after: the CLI with --fused-obs (K5 or
    K6 -> K1/K2), an imm DecoderSetup(fused_obs=True) (K5 -> K3/K4) and the
    fused decode API on the CLI batch (K9 -> K2), each call required to
    launch exactly those kernels. Then, outside the counts: melody lines
    must equal the default path's and track 0 the oracle on the port's own
    fused log observations, and K5, K6 and K9 are held against their plain
    versions on those inputs. Returns the launches."""
    spec, imm = family_spec("tonet"), family_spec("imm")
    paths, logits0 = ctx["paths"], ctx["cli_logits"][0]
    imm_setup = dataclasses.replace(ctx["imm_setup"], fused_obs=True)
    lengths = np.array([lg.shape[0] for lg in ctx["cli_logits"]], np.int32)
    staged = np.zeros((len(lengths), lengths.max(), spec.n_bins), np.float32)
    for i, lg in enumerate(ctx["cli_logits"]):
        staged[i, : lengths[i]] = lg
    batch = torch.from_numpy(staged).to(dev)

    # the entry points alone, each launching its own kernels; nothing else
    # launches a kernel until the counts are read
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    fused_recs = {
        method: run_counted(
            {"K5" if method == "shaun" else "K6", "K1", "K2"}, f"CLI --fused-obs {method}",
            cli_decode.main,
            [str(p) for p in paths]
            + ["--family", "tonet", "--artifacts", str(ctx["hmm"]), "--out",
               str(ctx["hmm"].parent / f"fused-{method}"), "--method", method,
               "--format", "npz", "--fused-obs"])
        for method in METHODS
    }
    cli_s = time.perf_counter() - t0
    lines = run_counted({"K5", "K3", "K4"}, "imm DecoderSetup(fused_obs=True)",
                        imm_setup.decode_batch, ctx["imm_logits"])
    api_states = {}
    for method in METHODS:
        setup = ctx["cli_setups"][method]
        api_states[method] = run_counted(
            {"K9", "K2"}, f"viterbi_decode_batch_fused_obs {method}",
            VD.viterbi_decode_batch_fused_obs, transition_matrix=setup.transition_matrix,
            prob_init=setup.init_probs, logits=batch, lengths=lengths,
            obs=setup.obs_config()).cpu().numpy()
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    emit({"phase": "fused_path", "cli_methods": list(METHODS), "cli_seconds": cli_s,
          "imm_tracks": len(lines), "api_tracks": len(lengths), "launches": launches})
    check(all(launches[k] > 0 for k in ("K5", "K6", "K9")),
          f"every kernel of the fused path ran: {launches}")

    # what came out (these launches come after the counts and do not count)
    def oracle_ok(setup, states0, lg0):
        lo = OF.log_obs(torch.from_numpy(lg0)[None].to(dev), setup.obs_config())[0]
        log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
        return np.array_equal(states0, viterbi_oracle_log(log_B, log_pi, lo.cpu().numpy()))

    for method, recs in fused_recs.items():
        for rec, want in zip(recs, ctx["cli_recs"][method]):
            check(np.array_equal(rec["voiced"], want["voiced"])
                  and np.array_equal(rec["bins"], want["bins"]),
                  f"{method}: --fused-obs {rec['name']} equals the default path's line")
        setup = dataclasses.replace(ctx["cli_setups"][method], fused_obs=True)
        check(oracle_ok(setup, np.where(recs[0]["voiced"], recs[0]["bins"], spec.n_bins),
                        logits0), f"{method}: --fused-obs track 0 equals the oracle")
    for (v, b), (wv, wb) in zip(lines, ctx["imm_lines"]):
        check(np.array_equal(v, wv) and np.array_equal(b, wb),
              "imm DecoderSetup(fused_obs=True) equals the default path's lines")
    check(oracle_ok(imm_setup, np.where(lines[0][0], lines[0][1], imm.n_bins),
                    ctx["imm_logits"][0]), "imm fused track 0 equals the oracle")
    for method, states in api_states.items():
        for i, want in enumerate(ctx["cli_recs"][method]):
            st = states[i, : lengths[i]]
            check(np.array_equal(st < spec.n_bins, want["voiced"])
                  and np.array_equal(np.minimum(st, spec.n_bins - 1), want["bins"]),
                  f"{method}: the fused decode API's track {i} equals the default path's line")
        check(oracle_ok(ctx["cli_setups"][method], states[0, : lengths[0]], logits0),
              f"{method}: the fused decode API's track 0 equals the oracle")

    # K5, K6 and K9 against their plain versions on those inputs (after the
    # counts are read)
    for method in METHODS:
        obs = ctx["cli_setups"][method].obs_config()
        err = check_obs(OF.log_obs(batch, obs), OF.log_obs_plain(batch, obs), obs,
                        f"main path tonet 361 {method}")
        k = "K5" if method == "shaun" else "K6"
        errs[k] = max(errs[k], err)
        st = ctx["cli_setups"][method]
        compare_k9(st.transition_matrix, st.init_probs, batch, lengths, obs,
                   "main path tonet 361", errs)
    imm_len = [lg.shape[0] for lg in ctx["imm_logits"]]
    imm_batch = np.zeros((len(imm_len), max(imm_len), imm.n_bins), np.float32)
    for i, lg in enumerate(ctx["imm_logits"]):
        imm_batch[i, : imm_len[i]] = lg
    imm_batch = torch.from_numpy(imm_batch).to(dev)
    obs = imm_setup.obs_config()
    errs["K5"] = max(errs["K5"], check_obs(OF.log_obs(imm_batch, obs),
                                           OF.log_obs_plain(imm_batch, obs), obs,
                                           "main path imm 722 shaun spw 20"))
    return launches


# ----------------------------------------------------------------------
# The window kernels K7/K8: the sequence-parallel decode; the track-sharded
# paths; streaming.
# ----------------------------------------------------------------------

SEQ_T = 32768  # bench.py's T: one track of about 5.5 min at 10 ms
SEQ_BLOCKS = 8
SEQ_HALO = 64


def window_cases():
    """(label, A, pi) of the window kernels: bench.py's tonet matrix (shaped,
    which K7/K8 take as dense) and imm's analytic 722-state matrix."""
    return [("tonet 361", *shaped_matrix(360, 14, 0)),
            ("imm 722", hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))]


def compare_windows(A, pi, log_obs, lengths, resets):
    """K7/K8 against their plain versions over a batch of windows: (forward
    error, backtrace error, every window with reset row 0 equals the
    oracle). The errors are the largest absolute differences of t1_last, of
    t1m1 up to each window's length and of the states."""
    log_B, log_pi = prepare_log_params(A, pi)
    dev = log_obs.device
    lB, lpi = torch.from_numpy(log_B).to(dev), torch.from_numpy(log_pi).to(dev)
    t1_k, m_k = VD.window_forward(log_B, log_pi, log_obs, lengths, resets)
    t1_p, m_p = VD.window_forward_plain(lB, lpi, log_obs, lengths, resets)
    start = torch.argmax(t1_p, dim=1)
    st_k = VD.window_backtrace(log_B, m_k, start, lengths)
    st_p = VD.window_backtrace_plain(lB, m_p, start, lengths)
    torch.cuda.synchronize()
    f_err = float((t1_k - t1_p).abs().max())
    b_err, oracle_ok = 0.0, True
    for n, L in enumerate(lengths):
        L = int(L)
        f_err = max(f_err, float((m_k[n, :L] - m_p[n, :L]).abs().max()))
        b_err = max(b_err, float((st_k[n, :L] - st_p[n, :L]).abs().max()))
        if resets[n] == 0:
            oracle_ok = oracle_ok and bool(np.array_equal(st_k[n, :L].cpu().numpy(), viterbi_oracle_log(
                log_B, log_pi, log_obs[n, :L].cpu().numpy())))
    return f_err, b_err, oracle_ok


def record_window_errors(errs, label, N, W, f_err, b_err, oracle_ok) -> None:
    errs["K7"] = max(errs["K7"], f_err)
    errs["K8"] = max(errs["K8"], b_err)
    emit({"phase": "window_equality", "shape": label, "windows": N, "W": W,
          "forward_max_abs_err": f_err, "backtrace_max_abs_err": b_err,
          "reset0_windows_match_oracle": oracle_ok})
    check(f_err == 0.0 and b_err == 0.0, f"K7/K8 {label}: kernels equal their plain versions")
    check(oracle_ok, f"K7/K8 {label}: windows with reset row 0 equal the oracle")


def phase_window_equality(dev, errs) -> None:
    """K7/K8 over 8 ragged windows of up to 1024 frames, reset rows 0, -1
    and 64, at 361 and 722 states."""
    rng = np.random.default_rng(4)
    N, W = 8, 1024
    resets = np.array([0, 0, SEQ_HALO, -1, 0, SEQ_HALO, -1, SEQ_HALO], np.int32)
    for label, A, pi in window_cases():
        lengths = rng.integers(W // 4, W + 1, N).astype(np.int32)
        lengths[0], lengths[1] = W, 1
        log_obs = uniform_log_obs(N, W, A.shape[0], seed=A.shape[0] + 1, dev=dev)
        record_window_errors(errs, label, N, W, *compare_windows(A, pi, log_obs, lengths, resets))


def block_windows(log_obs, H):
    """The time-block decode's SEQ_BLOCKS windows of a track on its device,
    stacked as K7 gets them, with their lengths and reset rows."""
    windows, lengths, resets = halo_windows(log_obs, [log_obs.device] * SEQ_BLOCKS, H)
    return torch.stack(windows), np.array(lengths, np.int32), np.array(resets, np.int32)


def phase_seq_path(dev, errs, ctx) -> tuple[dict, dict]:
    """The sequence-parallel and track-sharded paths through their entry
    points, the counts set to 0 just before them and read just after;
    then what came out, and K7/K8 against their plain versions on the
    inputs this path gave them. Returns the launches and what the timing
    phase reuses."""
    A, pi = shaped_matrix(360, 14, 0)
    log_B, log_pi = prepare_log_params(A, pi)
    g = torch.Generator(device=dev).manual_seed(2)
    logits = torch.randn((1, SEQ_T, 360), generator=g, device=dev).sub_(2.0)
    log_obs = OF.log_obs(logits, obs_cfg("shaun", 5, 0.0, None))[0]  # K5, before the counts
    del logits
    seq_mesh = make_mesh(seq=SEQ_BLOCKS, devices=[dev] * SEQ_BLOCKS)
    A_s, pi_s, obs_s, switch = make_seam_stress_hmm(SEQ_BLOCKS)
    sB, spi = prepare_log_params(A_s, pi_s)
    stress_obs = log_obs_fn(torch.from_numpy(obs_s).to(dev))
    imm_setup, tonet = ctx["imm_setup"], ctx["cli_setups"]["shaun"]
    imm_T = min(lg.shape[0] for lg in ctx["imm_logits"])
    imm_obs = torch.stack([log_obs_fn(imm_setup.observation_probs(lg[:imm_T]))
                           for lg in ctx["imm_logits"]])
    iB, ipi = prepare_log_params(imm_setup.transition_matrix, imm_setup.init_probs)
    data4 = make_mesh(data=4, devices=[dev] * 4)
    mesh_setup = dataclasses.replace(tonet, mesh=data4)
    fused_setup = dataclasses.replace(tonet, mesh=data4, fused_obs=True)

    # the entry points alone; nothing else launches a kernel until the
    # counts are read
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    (states, halo), seq_made = counted(viterbi_decode_time_sharded, log_B, log_pi, log_obs,
                                       seq_mesh, halo=SEQ_HALO)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    (stress_states, stress_halo), stress_made = counted(
        viterbi_decode_time_sharded, sB, spi, stress_obs, seq_mesh, halo=16)
    cli_mesh = {
        method: run_counted(
            {"K1": 1, "K2": 1}, f"CLI --mesh data=1 {method}", cli_decode.main,
            [str(p) for p in ctx["paths"]]
            + ["--family", "tonet", "--artifacts", str(ctx["hmm"]), "--out",
               str(ctx["hmm"].parent / f"mesh-{method}"), "--method", method,
               "--format", "npz", "--mesh", "data=1"])
        for method in METHODS
    }
    mesh_lines = run_counted({"K1": 4, "K2": 4}, "DecoderSetup(mesh=data 4)",
                             mesh_setup.decode_batch, ctx["cli_logits"])
    fused_lines = run_counted({"K5": 1, "K1": 4, "K2": 4}, "DecoderSetup(mesh=data 4, fused_obs)",
                              fused_setup.decode_batch, ctx["cli_logits"])
    imm_states = run_counted({"K3": 4, "K4": 4}, "decode_tracks_sharded imm 722",
                             decode_tracks_sharded, iB, ipi, imm_obs, data4)
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    tries = int(np.log2(halo // SEQ_HALO)) + 1 if halo > 0 else -1
    emit({"phase": "seq_path", "T": SEQ_T, "S": 361, "blocks": SEQ_BLOCKS, "final_halo": halo,
          "halos_tried": tries, "seconds": seq_s, "stress_final_halo": stress_halo,
          "launches_time_sharded": seq_made, "launches_stress": stress_made,
          "launches": launches})

    # what came out (these launches come after the counts and do not count)
    check(halo != -1, "the tonet track's seam certificate passed below the block length")
    check(seq_made == {"K7": tries, "K8": tries},
          f"the time-sharded decode launched one K7 and one K8 per halo tried: {seq_made}")
    check(stress_made == {"K7": 3, "K8": 3} and stress_halo == 64,
          f"seam stress: two forced doublings 16 -> 32 -> 64 ({stress_halo}, {stress_made})")
    t1_last, t1m1 = VD.viterbi_forward(log_B, log_pi, log_obs, SEQ_T)
    single = VD.viterbi_backtrace(t1m1, log_B, torch.argmax(t1_last), SEQ_T).cpu().numpy()
    del t1m1
    check(np.array_equal(states.cpu().numpy(), single),
          "the time-sharded states equal the single-track K7 -> K8 decode")
    t0 = time.perf_counter()
    oracle = viterbi_oracle_log(log_B, log_pi, log_obs.cpu().numpy())
    oracle_s = time.perf_counter() - t0
    check(np.array_equal(single, oracle), "the single-track decode equals the oracle")
    exact = viterbi_oracle_log(sB, spi, stress_obs.cpu().numpy())
    check(int(np.argmax(exact == 1)) == switch, "seam stress: the exact path switches at the nudge")
    check(np.array_equal(stress_states.cpu().numpy(), exact), "seam stress: the exact path")
    stress = {}
    for h, should_pass in ((16, False), (32, False), (64, True)):
        st, seams = viterbi_sharded_time_blocks(sB, spi, stress_obs, seq_mesh, halo=h)
        ok, match = bool(seams.all()), np.array_equal(st.cpu().numpy(), exact)
        stress[h] = ok
        check(ok == should_pass and (match or not ok) and (match or not should_pass),
              f"seam stress at halo {h}: certificate {ok}, exact path {match}")
    for method, recs in cli_mesh.items():
        for rec, want in zip(recs, ctx["cli_recs"][method]):
            check(np.array_equal(rec["voiced"], want["voiced"])
                  and np.array_equal(rec["bins"], want["bins"]),
                  f"{method}: --mesh data=1 {rec['name']} equals the unsharded line")
    for lines, label in ((mesh_lines, "default"), (fused_lines, "fused_obs")):
        for (v, b), want in zip(lines, ctx["cli_recs"]["shaun"]):
            check(np.array_equal(v, want["voiced"]) and np.array_equal(b, want["bins"]),
                  f"DecoderSetup(mesh=data 4, {label}) equals the unsharded lines")
    one = VD.viterbi_decode_batch_logobs(transition_matrix=imm_setup.transition_matrix,
                                         prob_init=imm_setup.init_probs, log_obs=imm_obs,
                                         lengths=np.full(len(imm_obs), imm_T, np.int32))
    check(torch.equal(imm_states, one), "decode_tracks_sharded equals the unsharded decode")
    check(np.array_equal(imm_states[0].cpu().numpy(),
                         viterbi_oracle_log(iB, ipi, imm_obs[0].cpu().numpy())),
          "decode_tracks_sharded track 0 equals the oracle")
    emit({"phase": "seq_path_checks", "time_sharded_equals_single_track": True,
          "single_track_equals_oracle": True, "oracle_seconds": oracle_s,
          "stress_certificate_by_halo": stress, "mesh_lines_equal_unsharded": True})

    # K7/K8 against their plain versions on this path's windows: the 8
    # blocks at the final halo and the whole track as one window
    windows, lengths, resets = block_windows(log_obs, halo)
    record_window_errors(errs, f"seq path tonet 361 halo {halo}", SEQ_BLOCKS, windows.shape[1],
                         *compare_windows(A, pi, windows, lengths, resets))
    del windows
    record_window_errors(errs, "seq path tonet 361 whole track", 1, SEQ_T,
                         *compare_windows(A, pi, log_obs[None], np.array([SEQ_T], np.int32),
                                          np.zeros(1, np.int32)))
    return launches, dict(log_obs=log_obs, halo=halo, mesh=seq_mesh, A=A, pi=pi)


# ----------------------------------------------------------------------
# The transcription path: wav -> CFP -> TONet -> observations -> decode.
# ----------------------------------------------------------------------

TRANSCRIBE_TRACKS, TRANSCRIBE_SECONDS, TRANSCRIBE_SR = 8, 60, 8000
EXCERPT_SECONDS, SHORT_SECONDS = 15.36, 20.0
VOICING_TH = 0.01
# card against CPU, on the same input (features: the same wav; logits: the
# card's features): max |diff| over the CPU's largest |value|, and for the
# logits also the relative L2 error. The CFP chain runs in float64 on both
# (frontend/cfp.py), so its float32 features agree to rounding. The NSGT
# (dcnet) runs in complex64 on both: its feature (range [0, 1]) is held to
# the 1e-4 the port's tests hold it to against the JAX package's
# (tests/test_torch_nsgt.py: two float32 FFT libraries near the -120 dB floor). msnet's
# argmax pool reroutes a value where a near-tie flips between two sum
# orders (tests/test_precision.py says as much for bfloat16), so its
# largest difference is loose and its L2 error tight.
FEATURE_TOL = {"tonet": 1e-5, "ftanet": 1e-5, "msnet": 1e-5, "jdc": 1e-5, "dcnet": 1e-4}
LOGIT_TOL = {"tonet": (1e-4, 5e-5), "ftanet": (1e-4, 5e-5), "msnet": (5e-2, 1e-3),
             "jdc": (1e-4, 5e-5), "dcnet": (1e-4, 5e-5)}


def write_melody_wav(path: Path, rng, seconds: float, sr: int = TRANSCRIBE_SR) -> None:
    """A harmonic tone following a seeded melody walk (a note every 0.25 s,
    MIDI 48-76, a fifth of the notes silent) plus noise, PCM16."""
    n_notes = int(np.ceil(seconds / 0.25))
    walk = np.clip(62 + np.cumsum(rng.integers(-2, 3, n_notes)), 48, 76).astype(np.float64)
    voiced = rng.random(n_notes) > 0.2
    per = int(0.25 * sr)
    f0 = np.repeat(440.0 * 2.0 ** ((walk - 69) / 12), per)[: int(seconds * sr)]
    amp = np.repeat(voiced.astype(np.float64), per)[: len(f0)]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = amp * sum(a * np.sin(k * phase) for k, a in ((1, 0.5), (2, 0.25), (3, 0.15), (4, 0.08)))
    x = x + 0.03 * rng.normal(size=len(x))
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767 * 0.8).astype(np.int16))


def card_against_cpu(dev, family: str, wav: Path, model_kwargs: dict, seed: int,
                     model=None) -> dict:
    """One family's front-end on the card against the CPU's on one wav, and
    its model (`model` on the CPU, else a seeded torch init at full width)
    on the card against the CPU on the card's features."""
    from viterbi_spl_tpu_torch.apps.common import init_model, model_logits_for_dataset
    from viterbi_spl_tpu_torch.cli import transcribe as TR
    from viterbi_spl_tpu_torch.io.wav import load_wav

    samples = load_wav(wav, sr=TR.FAMILY_SR[family])[0]
    f_card = TR.features_from_samples(family, samples, device=dev)
    f_cpu = TR.features_from_samples(family, samples, device="cpu")
    f_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    cfg = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}").config()
    if model is None:
        model, _, _ = init_model(cfg, model_kwargs, seed=seed)
    ds = TR._WavDataset(["x"], [f_card])
    lg_cpu = model_logits_for_dataset(cfg, model, ds)[0]
    t0 = time.perf_counter()
    lg_card = model_logits_for_dataset(cfg, model.to(dev), ds)[0]
    card_s = time.perf_counter() - t0
    l_err = float(np.abs(lg_card - lg_cpu).max() / np.abs(lg_cpu).max())
    rec = {"phase": "transcribe_card_vs_cpu", "family": family, "frames": len(f_card),
           "feature_shape": list(f_card.shape[1:]), "feature_max_abs_err_rel": f_err,
           "feature_tol": FEATURE_TOL[family], "logit_max_abs_err_rel": l_err,
           "logit_rel_l2": float(np.linalg.norm(lg_card - lg_cpu) / np.linalg.norm(lg_cpu)),
           "logit_tol": LOGIT_TOL[family], "card_model_seconds": card_s,
           "finite": bool(np.isfinite(lg_card).all())}
    emit(rec)
    check(np.isfinite(f_card).all() and rec["finite"], f"{family}: finite features and logits")
    check(f_err <= FEATURE_TOL[family],
          f"{family}: card features within {FEATURE_TOL[family]} of the CPU's")
    check(l_err <= LOGIT_TOL[family][0] and rec["logit_rel_l2"] <= LOGIT_TOL[family][1],
          f"{family}: card logits within {LOGIT_TOL[family]} of the CPU's")
    return rec


def reset_counts() -> None:
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0


def melody_states(recs, n_bins):
    return [np.where(r["voiced"], r["bins"], n_bins) for r in recs]


def check_oracle(setup, logits, states, what: str) -> None:
    """states equal the NumPy oracle's path on setup's log observations of
    logits (the port's PyTorch observation model on the setup's device)."""
    log_obs = log_obs_fn(setup.observation_probs(logits)).cpu().numpy()
    log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
    check(np.array_equal(states, viterbi_oracle_log(log_B, log_pi, log_obs)),
          f"{what} equals the oracle on the card's logits")


def staged_logits(logits, dev) -> torch.Tensor:
    """Per-track [T_i, n_bins] logits as one zero-filled [N, T_max, n_bins]
    batch on the card."""
    lengths = [lg.shape[0] for lg in logits]
    staged = np.zeros((len(logits), max(lengths), logits[0].shape[1]), np.float32)
    for i, lg in enumerate(logits):
        staged[i, : lengths[i]] = lg
    return torch.from_numpy(staged).to(dev)


def phase_transcribe(dev, tmp: Path) -> dict:
    """The transcription path through cli.transcribe.main on the card: 8
    synthetic 60 s wavs at 8 kHz, a full-width TONet checkpoint (seeded
    torch init: 360 bins, mode "all", the ftanet backbone, attn_dim 2048,
    128-frame snippets), tonet HMM artifacts from seeded note tracks. After
    a warm-up on track 0, with the counts set to 0 just before and read
    just after: --batch 16
    --method shaun (K1/K2), then --fused-obs (K5 -> K1/K2), then the card's
    logits through the fused decode API (K9 -> K2). Then, outside the
    counts: track 0's states equal the oracle on the card's logits; the
    CFP features and the model's logits on the card within the stated
    tolerance of the CPU's (a 15.36 s excerpt of track 0, 12 TONet
    chunks); one full-width forward of ftanet, msnet and jdc on a 20 s
    track against the CPU. Returns the launches and the stage times."""
    from viterbi_spl_tpu_torch.apps import tonet as tonet_app
    from viterbi_spl_tpu_torch.apps.common import float32_math, init_model
    from viterbi_spl_tpu_torch.cli import transcribe as TR
    from viterbi_spl_tpu_torch.harness.train import TrainState, save_checkpoint

    rng = np.random.default_rng(8)
    spec = family_spec("tonet")
    wavs = []
    for i in range(TRANSCRIBE_TRACKS):
        wavs.append(tmp / f"song{i}.wav")
        write_melody_wav(wavs[-1], rng, TRANSCRIBE_SECONDS)
    excerpt, short = tmp / "excerpt.wav", tmp / "short.wav"
    write_melody_wav(excerpt, np.random.default_rng(80), EXCERPT_SECONDS)
    write_melody_wav(short, np.random.default_rng(81), SHORT_SECONDS)
    _, params, batch_stats = init_model(tonet_app.config(), seed=11)
    ckpt = tmp / "tonet.pt"
    # the random model's posteriors are flat: a low validated threshold keeps
    # its paths voiced, so that the decode walks the pitch bins
    save_checkpoint(ckpt, TrainState(params, batch_stats, voicing_threshold=VOICING_TH), "tonet")
    notes = []
    for _ in range(4):
        walk = 60.0 + np.cumsum(rng.integers(-2, 3, 4000)) / 5.0
        notes.append(np.where(np.repeat(rng.random(200) > 0.25, 20), np.clip(walk, 40, 90), 0.0))
    build_hmm_artifacts(quantize_tracks_for_family(notes, spec), spec, tmp / "hmm_tr")
    common = [str(w) for w in wavs] + ["--family", "tonet", "--batch", "16", "--ckpt", str(ckpt),
                                       "--artifacts", str(tmp / "hmm_tr"), "--format", "npz",
                                       "--device", str(dev)]

    # a warm-up on track 0 (cuFFT plans, cuDNN's choices, the kernels'
    # first launches), before the counts are set to 0
    TR.main(common[:1] + common[TRANSCRIBE_TRACKS:] + ["--out", str(tmp / "warm")])
    reset_counts()
    stages, fused_stages = {}, {}
    t0 = time.perf_counter()
    recs = run_counted({"K1", "K2"}, "transcribe --method shaun", TR.main,
                       common + ["--out", str(tmp / "tr"), "--method", "shaun"], stages=stages)
    wall_s = time.perf_counter() - t0
    fused = run_counted({"K5", "K1", "K2"}, "transcribe --fused-obs", TR.main,
                        common + ["--out", str(tmp / "tr_fused"), "--fused-obs"],
                        stages=fused_stages)
    logits, _ = TR.nn_logits_from_wavs("tonet", wavs, str(ckpt), device=dev)
    setup = cli_decode.build_setup(argparse.Namespace(
        family="tonet", artifacts=str(tmp / "hmm_tr"), threshold=VOICING_TH, method="shaun",
        device=dev))
    lengths = np.array([lg.shape[0] for lg in logits], np.int32)
    api_states = run_counted(
        {"K9", "K2"}, "the transcribe logits through viterbi_decode_batch_fused_obs",
        VD.viterbi_decode_batch_fused_obs, transition_matrix=setup.transition_matrix,
        prob_init=setup.init_probs, logits=staged_logits(logits, dev), lengths=lengths,
        obs=setup.obs_config()).cpu().numpy()
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    check(all(launches[k] > 0 for k in ("K1", "K2", "K5", "K9")),
          f"the transcription path ran K1, K2, K5 and K9: {launches}")

    # what came out (these launches come after the counts and do not count)
    frames = int(lengths.sum())
    check(len(recs) == len(fused) == TRANSCRIBE_TRACKS
          and all(len(r["voiced"]) == L for r, L in zip(recs, lengths)),
          "one melody line a track, one entry a frame")
    check(frames == TRANSCRIBE_TRACKS * TRANSCRIBE_SECONDS * TRANSCRIBE_SR // 80,
          f"{frames} frames: 6000 a 60 s track at the 10 ms hop")
    for r, states, f, api, L in zip(recs, melody_states(recs, spec.n_bins),
                                    melody_states(fused, spec.n_bins), api_states, lengths):
        check(np.array_equal(states, f) and np.array_equal(states, api[:L]),
              f"{r['name']}: --fused-obs and the fused decode API give the CLI's states")
    check_oracle(setup, logits[0], melody_states(recs, spec.n_bins)[0],
                 "transcribe track 0 (6000 frames)")
    check(all(np.isfinite(lg).all() for lg in logits), "finite logits")

    with float32_math(dev):
        tf32_in_model = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                         "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    rec = {"phase": "transcribe", "tracks": TRANSCRIBE_TRACKS, "seconds_each": TRANSCRIBE_SECONDS,
           "frames": frames, "batch": 16, "model": "tonet all/ftanet attn_dim 2048",
           "stage_ms": {k: 1e3 * v for k, v in stages.items()},
           "stage_ms_fused_obs": {k: 1e3 * v for k, v in fused_stages.items()},
           "wall_ms": 1e3 * wall_s, "frames_per_s": frames / wall_s,
           "frames_per_s_fused_obs": frames / sum(fused_stages.values()),
           "voiced_share": float(np.mean(np.concatenate([r["voiced"] for r in recs]))),
           "tf32_default": {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
           "tf32_in_model_forward": tf32_in_model, "launches": launches}
    emit(rec)
    check(not any(tf32_in_model.values()), "the model forward runs without TF32")

    card_against_cpu(dev, "tonet", excerpt, {}, seed=11)
    for family, seed in (("ftanet", 12), ("msnet", 13), ("jdc", 14)):
        card_against_cpu(dev, family, short, {}, seed)
    return rec


# ----------------------------------------------------------------------
# The 44.1 kHz transcription paths: wav -> NSGT -> DCNet -> decode, and the
# checkpoint-free imm (sinebell STFT -> NMF fit -> log energies -> decode),
# with its --separate pass.
# ----------------------------------------------------------------------

HI_SR = 44100
DCNET_TRACKS, DCNET_SECONDS, DCNET_EXCERPT_SECONDS = 4, 60, 20.0
IMM_TRACKS, IMM_SECONDS, IMM_EXCERPT_SECONDS = 2, 30, 5.0
SEPARATE_SECONDS = 20.0
# card against CPU for imm, on the same 5 s excerpt: the power spectrogram
# (max |diff| over the CPU's largest power: float32 FFTs), then both fits
# from the CPU's spectrogram and the same draws: the same sweeps, and the
# log-energy logits within IMM_LOGIT_ATOL (the port's CPU tests hold them
# within 1e-4 of the JAX package's over 12-15 sweeps at the debug size;
# here up to 100 sweeps at the full size, with cuBLAS's sum orders)
IMM_SX_TOL = 1e-6
IMM_LOGIT_ATOL = 1e-3
# melody + accompaniment against the mix, per channel: mean squared error
# over the channel's mean square (tests/test_transcribe.py:172's bound)
SEPARATE_BOUND = 0.5


def write_stereo_wav(path: Path, rng, seconds: float, sr: int = HI_SR) -> np.ndarray:
    """A harmonic voice on a seeded melody walk (write_melody_wav's) over a
    noise accompaniment, panned apart (left 0.8 voice + 0.3 noise, right 0.4
    + 0.8), PCM16; returns the mix as read back [n, 2]."""
    from scipy.io import wavfile

    from viterbi_spl_tpu_torch.io.wav import load_wav

    voice_path = path.with_suffix(".voice.wav")
    write_melody_wav(voice_path, rng, seconds, sr)
    voice = load_wav(voice_path, sr=sr)[0]
    acc = 0.15 * rng.normal(size=len(voice))
    mix = np.stack([0.8 * voice + 0.3 * acc, 0.4 * voice + 0.8 * acc], 1)
    wavfile.write(path, sr, (np.clip(mix, -1, 1) * 32767).astype(np.int16))
    return load_wav(path, sr=sr, mono=False)[0]


def dcnet_checkpoint(path: Path, seed: int, features: np.ndarray) -> None:
    """A DCNet checkpoint at its published widths: a seeded torch init whose
    BatchNorm running statistics are each layer's input statistics on
    `features` (a synthetic track's NSGT feature, on the CPU), as training
    leaves them, so that eval mode normalizes every layer. (With the init's
    own statistics, or drawn ones, the activations shrink layer by layer and
    the logits come out flat: 0.009 apart over a whole track, where
    every decode is a near-tie.)"""
    from viterbi_spl_tpu_torch.apps import dcnet as dcnet_app
    from viterbi_spl_tpu_torch.apps.common import init_model
    from viterbi_spl_tpu_torch.harness.train import TrainState, save_checkpoint, split_state_dict
    from viterbi_spl_tpu_torch.models.layers import BatchNorm

    model, _, _ = init_model(dcnet_app.config(), seed=seed)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def keep_stats(module, args):
        x = args[0].to(torch.float32)
        axes = [d for d in range(x.ndim) if d != 1]
        mean = x.mean(dim=axes)
        shape = [1, -1] + [1] * (x.ndim - 2)
        module.mean.copy_(mean)
        module.var.copy_(((x - mean.view(shape)) ** 2).mean(dim=axes))

    hooks = [m.register_forward_pre_hook(keep_stats) for m in norms]
    with torch.no_grad():
        model(torch.from_numpy(features[None]), batch_stats=True)
    for h in hooks:
        h.remove()
    params, batch_stats = split_state_dict(model)
    save_checkpoint(path, TrainState(params, batch_stats, voicing_threshold=VOICING_TH), "dcnet")


def phase_dcnet(dev, errs, tmp: Path) -> dict:
    """dcnet through cli.transcribe.main on the card: 4 synthetic 60 s wavs
    at 44.1 kHz, a DCNet checkpoint at its published widths, dcnet HMM
    artifacts from seeded note tracks. After a warm-up on track 0, with the
    counts set to 0 just before and read just after: --method shaun (K1/K2),
    --fused-obs (K5 -> K1/K2), then the card's logits through the fused
    decode API (K9 -> K2). Then: the same states from all three, track 0
    equal to the oracle, K1/K2, K5 and K9 against their plain versions on
    the path's inputs, the NSGT feature and DCNet's logits on the card
    against the CPU's on a 20 s excerpt."""
    from viterbi_spl_tpu_torch.apps.common import load_state
    from viterbi_spl_tpu_torch.cli import transcribe as TR
    from viterbi_spl_tpu_torch.frontend.nsgt import dcnet_feature, nsgt_for_length
    from viterbi_spl_tpu_torch.harness.train import restore_checkpoint
    from viterbi_spl_tpu_torch.io.wav import load_wav
    from viterbi_spl_tpu_torch.models import DCNet

    rng = np.random.default_rng(9)
    spec = family_spec("dcnet")
    wavs = [tmp / f"dc{i}.wav" for i in range(DCNET_TRACKS)]
    for w in wavs:
        write_melody_wav(w, rng, DCNET_SECONDS, HI_SR)
    excerpt = tmp / "dc_excerpt.wav"
    write_melody_wav(excerpt, np.random.default_rng(90), DCNET_EXCERPT_SECONDS, HI_SR)
    ckpt = tmp / "dcnet.pt"
    calib = tmp / "dc_calib.wav"
    write_melody_wav(calib, np.random.default_rng(91), 10.0, HI_SR)
    dcnet_checkpoint(ckpt, 21, TR.features_from_samples(
        "dcnet", load_wav(calib, sr=HI_SR)[0], device="cpu"))
    notes = []
    for _ in range(4):
        walk = 60.0 + np.cumsum(rng.integers(-2, 3, 4000)) / 5.0
        notes.append(np.where(np.repeat(rng.random(200) > 0.25, 20), np.clip(walk, 40, 90), 0.0))
    art = build_hmm_artifacts(quantize_tracks_for_family(notes, spec), spec, tmp / "hmm_dc")
    bstruct = VB.extract_banded_structure(art["transition_matrix"])
    check(bstruct is not None, "dcnet's shaped matrix is banded")
    common = [str(w) for w in wavs] + ["--family", "dcnet", "--batch", "16", "--ckpt", str(ckpt),
                                       "--artifacts", str(tmp / "hmm_dc"), "--format", "npz",
                                       "--device", str(dev)]

    TR.main(common[:1] + common[DCNET_TRACKS:] + ["--out", str(tmp / "dc_warm")])
    reset_counts()
    stages, fused_stages = {}, {}
    t0 = time.perf_counter()
    recs = run_counted({"K1", "K2"}, "transcribe --family dcnet", TR.main,
                       common + ["--out", str(tmp / "dc"), "--method", "shaun"], stages=stages)
    wall_s = time.perf_counter() - t0
    fused = run_counted({"K5", "K1", "K2"}, "transcribe --family dcnet --fused-obs", TR.main,
                        common + ["--out", str(tmp / "dc_fused"), "--fused-obs"],
                        stages=fused_stages)
    logits, _ = TR.nn_logits_from_wavs("dcnet", wavs, str(ckpt), device=dev)
    setup = cli_decode.build_setup(argparse.Namespace(
        family="dcnet", artifacts=str(tmp / "hmm_dc"), threshold=VOICING_TH, method="shaun",
        device=dev))
    lengths = np.array([lg.shape[0] for lg in logits], np.int32)
    batch = staged_logits(logits, dev)
    api_states = run_counted(
        {"K9", "K2"}, "the dcnet logits through viterbi_decode_batch_fused_obs",
        VD.viterbi_decode_batch_fused_obs, transition_matrix=setup.transition_matrix,
        prob_init=setup.init_probs, logits=batch, lengths=lengths,
        obs=setup.obs_config()).cpu().numpy()
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}

    # what came out (these launches come after the counts and do not count)
    frames = int(lengths.sum())
    check(len(recs) == len(fused) == DCNET_TRACKS
          and all(len(r["voiced"]) == L for r, L in zip(recs, lengths)),
          "dcnet: one melody line a track, one entry a frame")
    check(frames == DCNET_TRACKS * -(-DCNET_SECONDS * HI_SR // 256),
          f"dcnet: {frames} frames, one a 256-sample hop")
    for st, f, api, L in zip(melody_states(recs, spec.n_bins),
                             melody_states(fused, spec.n_bins), api_states, lengths):
        check(np.array_equal(st, f) and np.array_equal(st, api[:L]),
              "dcnet: --fused-obs and the fused decode API give the CLI's states")
    check_oracle(setup, logits[0], melody_states(recs, spec.n_bins)[0],
                 f"dcnet track 0 ({lengths[0]} frames)")
    check(all(np.isfinite(lg).all() for lg in logits), "dcnet: finite logits")
    # the front-end stage of track 0 in parts (host seconds, the card
    # synchronised by each part's copy to the host)
    y0 = load_wav(wavs[0], sr=HI_SR)[0]
    nsgt = nsgt_for_length(len(y0), device=dev)
    t0 = time.perf_counter()
    nsgt.track_blocks(y0)
    t1 = time.perf_counter()
    mag = nsgt.transform_track(y0)
    t2 = time.perf_counter()
    dcnet_feature(mag)
    t3 = time.perf_counter()
    rec = {"phase": "transcribe_dcnet", "tracks": DCNET_TRACKS, "seconds_each": DCNET_SECONDS,
           "frames": frames, "batch": 16, "nsgt_Ls": nsgt.Ls, "band_d_max": bstruct.d_max,
           "front_end_ms_track0": {"track_blocks": 1e3 * (t1 - t0),
                                   "transform_track": 1e3 * (t2 - t1),
                                   "dcnet_feature": 1e3 * (t3 - t2)},
           "stage_ms": {k: 1e3 * v for k, v in stages.items()},
           "stage_ms_fused_obs": {k: 1e3 * v for k, v in fused_stages.items()},
           "wall_ms": 1e3 * wall_s, "frames_per_s": frames / wall_s,
           "frames_per_s_fused_obs": frames / sum(fused_stages.values()),
           "voiced_share": float(np.mean(np.concatenate([r["voiced"] for r in recs]))),
           "launches": launches}
    emit(rec)
    log_obs, _ = padded_log_obs(setup, logits)
    record_errors(errs, "banded", "transcribe dcnet 321", len(lengths), log_obs.shape[1],
                  *compare_kernels("banded", setup.transition_matrix, setup.init_probs,
                                   log_obs, lengths))
    obs = setup.obs_config()
    errs["K5"] = max(errs["K5"], check_obs(OF.log_obs(batch, obs), OF.log_obs_plain(batch, obs),
                                           obs, "transcribe dcnet 320 shaun spw 5"))
    compare_k9(setup.transition_matrix, setup.init_probs, batch, lengths, obs,
               "transcribe dcnet 321", errs)
    state, _, _ = restore_checkpoint(ckpt)
    model = DCNet().eval()
    load_state(model, state)
    card_against_cpu(dev, "dcnet", excerpt, {}, seed=21, model=model)
    return rec


def phase_imm(dev, errs, tmp: Path) -> dict:
    """imm through cli.transcribe.main on the card at the full IMMConfig():
    2 synthetic 30 s wavs at 44.1 kHz. After a warm-up on track 0, with the
    counts set to 0 just before and read just after: --family imm (K3/K4),
    then --fused-obs (K5 -> K3/K4); then one stereo 20 s wav through
    --separate (one K3 and one K4). Then: the same states with and without
    --fused-obs, track 0 equal to the oracle on the card's logits, K3/K4
    and K5 against their plain versions on the path's inputs, the
    separation reconstructing the mix per channel, and on a 5 s excerpt the
    card's power spectrogram and NMF fit against the CPU's."""
    from viterbi_spl_tpu_torch.cli import transcribe as TR
    from viterbi_spl_tpu_torch.io.wav import load_wav
    from viterbi_spl_tpu_torch.models.imm import IMM, IMMConfig

    rng = np.random.default_rng(10)
    wavs = [tmp / f"imm{i}.wav" for i in range(IMM_TRACKS)]
    for w in wavs:
        write_melody_wav(w, rng, IMM_SECONDS, HI_SR)
    excerpt = tmp / "imm_excerpt.wav"
    write_melody_wav(excerpt, np.random.default_rng(100), IMM_EXCERPT_SECONDS, HI_SR)
    stereo = tmp / "stereo.wav"
    mix = write_stereo_wav(stereo, np.random.default_rng(101), SEPARATE_SECONDS)
    common = [str(w) for w in wavs] + ["--family", "imm", "--batch", "16", "--format", "npz",
                                       "--device", str(dev)]

    TR.main(common[:1] + common[IMM_TRACKS:] + ["--out", str(tmp / "imm_warm")])
    kept = []
    real_logits = TR.imm_logits_from_wavs

    def keep_logits(*args, **kwargs):
        kept.append(real_logits(*args, **kwargs))
        return kept[-1]

    TR.imm_logits_from_wavs = keep_logits
    try:
        reset_counts()
        stages, fused_stages, sep_stages = {}, {}, {}
        t0 = time.perf_counter()
        recs = run_counted({"K3", "K4"}, "transcribe --family imm", TR.main,
                           common + ["--out", str(tmp / "imm")], stages=stages)
        wall_s = time.perf_counter() - t0
        fused = run_counted({"K5", "K3", "K4"}, "transcribe --family imm --fused-obs", TR.main,
                            common + ["--out", str(tmp / "imm_fused"), "--fused-obs"],
                            stages=fused_stages)
        seps = run_counted({"K3": 1, "K4": 1}, "transcribe --family imm --separate", TR.main,
                           [str(stereo), "--family", "imm", "--separate", "--device", str(dev),
                            "--out", str(tmp / "imm_sep")], stages=sep_stages)
        launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    finally:
        TR.imm_logits_from_wavs = real_logits

    # what came out (these launches come after the counts and do not count)
    imm = IMM(IMMConfig(), device=dev)
    U = imm.config.U
    logits = kept[0]
    lengths = [len(r["voiced"]) for r in recs]
    frames = int(sum(lengths))
    check(frames == IMM_TRACKS * -(-IMM_SECONDS * HI_SR // 256) and len(fused) == IMM_TRACKS,
          f"imm: {frames} frames, one a 256-sample hop")
    for st, f in zip(melody_states(recs, U), melody_states(fused, U)):
        check(np.array_equal(st, f), "imm: --fused-obs gives the CLI's states")
    setup = TR._imm_setup(imm, argparse.Namespace(method="shaun", threshold=None,
                                                  fused_obs=False, mesh=None, device=dev))
    check_oracle(setup, logits[0], melody_states(recs, U)[0], f"imm track 0 ({lengths[0]} frames)")
    log_obs, _ = padded_log_obs(setup, logits)
    record_errors(errs, "dense", "transcribe imm 722", len(lengths), log_obs.shape[1],
                  *compare_kernels("dense", setup.transition_matrix, setup.init_probs,
                                   log_obs, np.array(lengths, np.int32)))
    batch, obs = staged_logits(logits, dev), setup.obs_config()
    errs["K5"] = max(errs["K5"], check_obs(OF.log_obs(batch, obs), OF.log_obs_plain(batch, obs),
                                           obs, "transcribe imm 721 shaun spw 20"))
    check(all(np.isfinite(lg).all() for lg in logits), "imm: finite logits")
    sep = seps[0]
    recon = [float(np.mean((sep["melody"][:, c] + sep["accompaniment"][:, c] - mix[:, c]) ** 2)
                   / np.mean(mix[:, c] ** 2)) for c in (0, 1)]
    check(sep["melody"].shape == mix.shape and all(e < SEPARATE_BOUND for e in recon),
          f"imm --separate: melody + accompaniment reconstruct the mix per channel: {recon}")
    for part in ("melody", "accompaniment"):
        out, sr = load_wav(tmp / "imm_sep" / f"stereo_{part}.wav", mono=False)
        check(sr == HI_SR and out.shape == mix.shape, f"imm --separate wrote {part}")

    # card against CPU on a 5 s excerpt: the spectrogram, then both fits
    # from the CPU's spectrogram and the same draws
    y = load_wav(excerpt, sr=HI_SR)[0]
    cpu = IMM(IMMConfig(), device="cpu")
    SX_cpu = cpu.power_spectrogram(y)
    sx_err = float((imm.power_spectrogram(y).cpu() - SX_cpu).abs().max() / SX_cpu.max())
    t0 = time.perf_counter()
    fit_cpu = cpu.fit(SX_cpu)
    cpu_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit_card = imm.fit(SX_cpu)
    card_fit_s = time.perf_counter() - t0
    lg_cpu, lg_card = cpu.logits_from_fit(fit_cpu, SX_cpu), imm.logits_from_fit(fit_card, SX_cpu)
    l_err = float(np.abs(lg_card - lg_cpu).max())
    sweeps = stages["sweeps"]
    rec = {"phase": "transcribe_imm", "tracks": IMM_TRACKS, "seconds_each": IMM_SECONDS,
           "frames": frames, "config": "IMMConfig() (w 2048, h 256, U 721, R 40, P 30, K 10)",
           "sweeps": sweeps, "sweeps_fused_obs": fused_stages["sweeps"],
           "ms_per_sweep": 1e3 * stages["nmf_fit"] / sum(sweeps),
           "stage_ms": {k: 1e3 * v for k, v in stages.items() if k != "sweeps"},
           "stage_ms_fused_obs": {k: 1e3 * v for k, v in fused_stages.items() if k != "sweeps"},
           "wall_ms": 1e3 * wall_s, "frames_per_s": frames / wall_s,
           "frames_per_s_fused_obs": frames / sum(v for k, v in fused_stages.items()
                                                  if k != "sweeps"),
           "voiced_share": float(np.mean(np.concatenate([r["voiced"] for r in recs]))),
           "separate": {"seconds": SEPARATE_SECONDS, "frames": len(sep["states"]),
                        "sweeps": list(sep["sweeps"]),
                        "stage_ms": {k: 1e3 * v for k, v in sep_stages.items()},
                        "recon_err": recon, "recon_bound": SEPARATE_BOUND},
           "card_vs_cpu": {"seconds": IMM_EXCERPT_SECONDS, "frames": int(SX_cpu.shape[0]),
                           "sx_max_abs_err_rel": sx_err, "sx_tol": IMM_SX_TOL,
                           "sweeps_card": fit_card["sweeps"], "sweeps_cpu": fit_cpu["sweeps"],
                           "err_card": fit_card["err"], "err_cpu": fit_cpu["err"],
                           "logit_max_abs_err": l_err, "logit_tol": IMM_LOGIT_ATOL,
                           "card_fit_ms": 1e3 * card_fit_s, "cpu_fit_ms": 1e3 * cpu_fit_s},
           "launches": launches}
    emit(rec)
    check(sx_err <= IMM_SX_TOL, f"imm: card spectrogram within {IMM_SX_TOL} of the CPU's")
    check(fit_card["sweeps"] == fit_cpu["sweeps"], "imm: card and CPU fits run the same sweeps")
    check(l_err <= IMM_LOGIT_ATOL, f"imm: card logits within {IMM_LOGIT_ATOL} of the CPU's")
    return rec


# ----------------------------------------------------------------------
# The training path: apps.tonet train -> Trainer -> checkpoint -> infer and
# sweep-obs (K1/K2), TONet at its published width.
# ----------------------------------------------------------------------

TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH = 2, 20
TRAIN_COMPARE_STEPS, TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 3, 2, 5
TRAIN_SEED = 41
# card against CPU, TRAIN_COMPARE_STEPS TONet steps from the same weights (a
# CPU generator's draws) and batches, dropout off: each step's loss within
# TRAIN_LOSS_RTOL; the BatchNorm running averages after the first step
# within TRAIN_BN_TOL (bn_error: a running mean's difference over its
# channel's standard deviation, a running variance's over itself; a mean
# that is ~0, as after a BatchNorm, is float noise on both) (later steps' are
# printed: from the first update on the two runs' params drift apart, by up
# to 2 lr where a gradient element near 0 took the other sign, which moves
# the batch statistics); the first step's gradient within TRAIN_GRAD_TOL: (relative L2 of the whole gradient, each tensor's
# largest difference over the whole gradient's largest |g|). A tensor's
# largest difference over its own largest |g| is printed, not held: TONet's
# float32 gradients are ill-conditioned (BatchNorm's backward through batch
# statistics, the attention softmaxes), so that on the CPU alone float32
# and float64 differ by up to 8.7e-2 of a small tensor's largest at a
# narrow width (scripts/train_precision_probe.py); the bounds are those
# tests/test_torch_apps_cfp.py holds TONet to against the JAX package (its
# float32 sum orders against the port's).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_BN_TOL = 1e-4
TRAIN_GRAD_TOL = (3e-2, 3e-2)


def _host64(tensors: dict) -> dict:
    return {k: t.detach().to("cpu", torch.float64) for k, t in tensors.items()}


def bn_error(got: dict, want: dict) -> float:
    """The largest difference of BatchNorm running averages: a mean's over
    its channel's standard deviation (want's running variance), a
    variance's over itself."""
    worst = 0.0
    for k, w in want.items():
        scale = want[k[: -len("mean")] + "var"].sqrt() if k.endswith(".mean") else w
        worst = max(worst, float(((got[k] - w).abs() / scale).max()))
    return worst


def train_card_against_cpu(dev, cfg, batches) -> dict:
    """TRAIN_COMPARE_STEPS train steps of the full-width TONet on the card
    and on the CPU from the same weights and batches, dropout off (the step's
    dropout generator None)."""
    from viterbi_spl_tpu_torch.apps import common as AC

    runs = {}
    dropout_generator = AC.dropout_generator
    AC.dropout_generator = lambda *args, **kwargs: None
    try:
        for name, d in (("cpu", "cpu"), ("card", dev)):
            model, params, stats = AC.init_model(cfg, seed=TRAIN_SEED, device=d)
            opt = AC.make_optimizer(cfg, model, TRAIN_STEPS_PER_EPOCH)
            step = AC.make_train_step(cfg, model)
            rec = {"loss": [], "stats": []}
            t0 = time.perf_counter()
            for s, batch in enumerate(batches):
                loss = step(params, stats, opt, batch, s, 0.5)[3]
                rec["loss"].append(float(loss))
                if s == 0:
                    rec["grads"] = _host64({k: p.grad for k, p in params.items()
                                            if p.grad is not None})
                rec["stats"].append(_host64(stats))
            rec["seconds"] = time.perf_counter() - t0
            rec["params"] = _host64(params)
            runs[name] = rec
            del model, params, stats, opt, step
    finally:
        AC.dropout_generator = dropout_generator
    cpu, card = runs["cpu"], runs["card"]
    g_cpu = torch.cat([g.flatten() for g in cpu["grads"].values()])
    g_card = torch.cat([card["grads"][k].flatten() for k in cpu["grads"]])
    g_max = float(g_cpu.abs().max())
    per_tensor = {k: float((card["grads"][k] - g).abs().max()) for k, g in cpu["grads"].items()}
    own_max = {k: per_tensor[k] / max(float(g.abs().max()), 1e-30) for k, g in cpu["grads"].items()}
    bn_err = [bn_error(c, w) for c, w in zip(card["stats"], cpu["stats"])]
    drift = max(float((card["params"][k] - p).abs().max()) for k, p in cpu["params"].items())
    worst = sorted(own_max.items(), key=lambda kv: -kv[1])[:3]
    res = {"losses_cpu": cpu["loss"], "losses_card": card["loss"],
           "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(card["loss"], cpu["loss"])],
           "grad_rel_l2": float((g_card - g_cpu).norm() / g_cpu.norm()),
           "grad_max_err_over_global_max": max(per_tensor.values()) / g_max,
           "grad_worst_tensors_own_max": worst, "bn_max_err_rel_by_step": bn_err,
           "param_drift_max_abs": drift, "param_drift_in_lr": drift / cfg.learning_rate,
           "cpu_seconds": cpu["seconds"], "card_seconds": card["seconds"]}
    emit({"phase": "train_card_vs_cpu", **res})
    check(all(np.isfinite(cpu["loss"] + card["loss"])), "train card vs CPU: finite losses")
    check(max(res["loss_rel_err"]) <= TRAIN_LOSS_RTOL,
          f"train card vs CPU: losses within rtol {TRAIN_LOSS_RTOL}: {res['loss_rel_err']}")
    check(res["grad_rel_l2"] <= TRAIN_GRAD_TOL[0]
          and res["grad_max_err_over_global_max"] <= TRAIN_GRAD_TOL[1],
          f"train card vs CPU: first-step gradient within {TRAIN_GRAD_TOL}")
    check(bn_err[0] <= TRAIN_BN_TOL,
          f"train card vs CPU: BatchNorm averages after the first step within {TRAIN_BN_TOL}")
    return res


def phase_train(dev, smi: str, tmp: Path) -> dict:
    """The training path at TONet's published width (360 bins, attn_dim
    2048, mode "all", the ftanet backbone, 128-frame chunks, batch 4) on the
    card. apps.tonet.main train --synthetic (6 x 2,000 training frames, 3 + 3
    validation and test tracks) for TRAIN_EPOCHS epochs of
    TRAIN_STEPS_PER_EPOCH steps with a checkpoint and events.jsonl; then,
    the counts set to 0 just before each and read just after, infer
    (exactly K1/K2) and sweep-obs (K1/K2) on that checkpoint. Checks: every
    epoch's loss finite, one train_oa event an epoch, the checkpoint read by
    restore_checkpoint and by cli/transcribe's loader (a 5 s wav), the
    first test track's Viterbi states equal to the oracle's. Then the card
    against the CPU (train_card_against_cpu), and times: ms per train step
    (median of TRAIN_TIMED_STEPS after TRAIN_WARMUP_STEPS, each between
    CUDA events), training frames/s, ms per validation, ms per checkpoint
    save, infer ms, peak memory; each printed beside the card's name and
    power limit."""
    from viterbi_spl_tpu_torch.apps import common as AC
    from viterbi_spl_tpu_torch.apps import tonet as tonet_app
    from viterbi_spl_tpu_torch.cli import transcribe as TR
    from viterbi_spl_tpu_torch.harness.train import Trainer, TrainState, restore_checkpoint

    ckpt, log = tmp / "tonet_trained.pt", tmp / "train_log"
    common = ["--synthetic", "--ckpt", str(ckpt)]
    t0 = time.perf_counter()
    best = tonet_app.main(["train", *common, "--epochs", str(TRAIN_EPOCHS), "--steps-per-epoch",
                           str(TRAIN_STEPS_PER_EPOCH), "--patience", "5", "--log-dir", str(log)])
    train_s = time.perf_counter() - t0
    events = [json.loads(line) for line in (log / "events.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e.get("tag") == "train_loss"]
    check(len(losses) == TRAIN_EPOCHS and all(np.isfinite(losses)),
          f"train: one finite loss an epoch: {losses}")
    check(sum(e.get("tag") == "train_oa" for e in events) == TRAIN_EPOCHS,
          "train: events.jsonl has one train_oa an epoch")
    state, family, model_kwargs = restore_checkpoint(ckpt)
    check(family == "tonet" and state.opt_state is not None
          and state.step == TRAIN_STEPS_PER_EPOCH * (state.epoch + 1)
          and state.best_oa == best.best_oa,
          "train: the checkpoint holds the best epoch's state and Adam's")
    wav = tmp / "train_check.wav"
    write_melody_wav(wav, np.random.default_rng(31), 5.0)
    lg, _ = TR.nn_logits_from_wavs("tonet", [wav], str(ckpt), device=dev)
    check(lg[0].shape[1] == 360 and np.isfinite(lg[0]).all(),
          "train: cli/transcribe's loader reads the trained checkpoint")

    reset_counts()
    t0 = time.perf_counter()
    out = run_counted({"K1", "K2"}, "tonet infer on the trained checkpoint", tonet_app.main,
                      ["infer", *common])
    infer_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    reset_counts()
    sweep = run_counted({"K1", "K2"}, "tonet sweep-obs on the trained checkpoint", tonet_app.main,
                        ["sweep-obs", *common])
    sweep_launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    check(all(np.isfinite([out["validation"]["viterbi_mean_oa"], out["test"]["raw_mean_oa"]]))
          and np.all(np.isfinite(sweep["oa"])), "train: finite OAs from infer and sweep-obs")

    # the first test track's states against the oracle (infer's path)
    cfg = tonet_app.config()
    with torch.device("meta"):
        model = cfg.make_model(dtype=cfg.compute_dtype, **model_kwargs)
    model = model.to_empty(device=dev)
    AC.load_state(model, state)
    test = AC.synthetic_dataset(cfg, 3, 2000, 2)
    setup = AC.build_decoder_setup(cfg, AC.synthetic_dataset(cfg, 3, 2000, 1),
                                   state.voicing_threshold, device=dev)
    logits0 = AC.tracks_for_evaluation(cfg, model, test)[0]["logits"]
    voiced, bins = setup.decode(logits0)
    check_oracle(setup, logits0, np.where(voiced, bins, setup.n_bins), "train: test track 0")
    del model

    # the card against the CPU, then the times
    train_set = AC.synthetic_dataset(cfg, 6, 2000, 0)
    stream = AC.training_batches(cfg, train_set, np.random.default_rng(0), "cpu")
    vs_cpu = train_card_against_cpu(dev, cfg, [next(stream) for _ in range(TRAIN_COMPARE_STEPS)])
    torch.cuda.reset_peak_memory_stats()
    model, params, stats = AC.init_model(cfg, seed=TRAIN_SEED, device=dev)
    opt = AC.make_optimizer(cfg, model, TRAIN_STEPS_PER_EPOCH)
    step = AC.make_train_step(cfg, model)
    batches = AC.training_batches(cfg, train_set, np.random.default_rng(1), dev)
    step_ms = []
    for s in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS):
        batch = next(batches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, stats, opt, batch, s, 0.5)[3]
        end.record()
        end.synchronize()
        check(np.isfinite(float(loss)), "train: finite loss in the timed steps")
        if s >= TRAIN_WARMUP_STEPS:
            step_ms.append(start.elapsed_time(end))
    trainer = Trainer(step, AC.make_validate(cfg, model, AC.synthetic_dataset(cfg, 3, 2000, 1)),
                      ckpt_path=tmp / "tonet_timed.pt", family="tonet")
    live = TrainState(params, stats, opt_state=opt)
    t0 = time.perf_counter()
    trainer.validate(live)
    val_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.save(live)
    save_s = time.perf_counter() - t0
    ms = float(np.median(step_ms))
    rec = {"phase": "train", "model": "tonet all/ftanet attn_dim 2048", "batch": cfg.batch_size,
           "chunk_frames": cfg.snippet_len, "epochs": TRAIN_EPOCHS,
           "steps_per_epoch": TRAIN_STEPS_PER_EPOCH, "train_main_seconds": train_s,
           "epoch_losses": losses, "best_epoch": best.best_epoch, "best_val_oa": best.best_oa,
           "voicing_threshold": best.voicing_threshold,
           "train_step_ms": ms, "train_step_ms_all": step_ms,
           "train_frames_per_s": cfg.batch_size * cfg.snippet_len / (ms / 1e3),
           "validation_ms": 1e3 * val_s, "checkpoint_save_ms": 1e3 * save_s,
           "checkpoint_bytes": (tmp / "tonet_timed.pt").stat().st_size,
           "infer_ms": 1e3 * infer_s, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "params": sum(p.numel() for p in params.values()),
           "infer_oa": {s: [out[s]["raw_mean_oa"], out[s]["viterbi_mean_oa"]]
                        for s in ("validation", "test")},
           "card_vs_cpu": vs_cpu, "launches": launches, "launches_sweep_obs": sweep_launches}
    emit(rec)
    for what, value in (("ms per train step", f"{ms:.2f}"),
                        ("training frames/s", f"{rec['train_frames_per_s']:.0f}"),
                        ("ms per validation (3 x 2000 frames)", f"{rec['validation_ms']:.1f}"),
                        ("ms per checkpoint save", f"{rec['checkpoint_save_ms']:.1f} "
                                                   f"({rec['checkpoint_bytes']} bytes)"),
                        ("infer ms", f"{rec['infer_ms']:.1f}"),
                        ("max_memory_allocated bytes", str(rec["max_memory_allocated"]))):
        print(f"train phase, {smi}: {what} {value}", flush=True)
    return rec


# ----------------------------------------------------------------------
# The real-data chains on the fake corpus: wav/aiff -> front-end on the card
# -> model -> decode, train -> infer --external-eval (TONet at full width,
# msnet with --native-prefetch), imm's eval --external-eval --original at
# the full IMMConfig(); the native CPU decoder's rate on the host.
# ----------------------------------------------------------------------

REAL_SECONDS = 10.0  # the fake corpus's tracks: MedleyDB, external and RWC
REAL_TONET_STEPS = 10
REAL_EVAL_SETS = ("validation", "test", "adc04", "mirex05", "mir1k", "rwc")
# cross_check_diff_viterbi (the accumulated OA against the mir_eval-semantics
# score): exact where the family's estimate grid is the corpus's annotation
# timebase (msnet on the 256-hop grid: medleydb and adc04), else within the
# JAX drill's 0.05 (tests/test_fake_corpus.py:52-66)
REAL_STRICT_TOL, REAL_LOOSE_TOL = 1e-6, 0.05
NATIVE_S, NATIVE_T = 361, 2000


class _Timed:
    """fn, recording each call's seconds, the card synchronised at both ends,
    under label(*args, **kwargs)."""

    def __init__(self, fn, label=lambda *args, **kwargs: None):
        self.fn, self.label, self.calls = fn, label, []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((self.label(*args, **kwargs), time.perf_counter() - t0))
        return out


def check_external_infer(out, family: str, strict=()) -> dict:
    """All six eval sets with finite raw and Viterbi OAs and the cross-check
    within REAL_STRICT_TOL (strict sets) or REAL_LOOSE_TOL -> {set: [raw OA,
    Viterbi OA, largest |cross-check diff|]}."""
    got = [k for k in out if k != "state"]
    check(got == list(REAL_EVAL_SETS), f"{family} infer --external-eval: eval sets {got}")
    rec = {}
    for name in REAL_EVAL_SETS:
        res = out[name]
        diff = max(abs(d) for d in res["cross_check_diff_viterbi"])
        rec[name] = [res["raw_mean_oa"], res["viterbi_mean_oa"], diff]
        check(np.isfinite(res["raw_mean_oa"]) and np.isfinite(res["viterbi_mean_oa"]),
              f"{family} {name}: finite OAs")
        tol = REAL_STRICT_TOL if name in strict else REAL_LOOSE_TOL
        check(diff < tol, f"{family} {name}: cross-check {diff} within {tol}")
    return rec


def step_times(step, params, stats, opt, batches, first_step: int) -> dict:
    """TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS train steps on `batches`: each
    timed step between CUDA events (median), and the host's wall time per
    timed step with its batch drawn, the card synchronised at both ends."""
    events = []
    for s in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS):
        if s == TRAIN_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        batch = next(batches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, stats, opt, batch, first_step + s, 0.5)[3]
        end.record()
        if s >= TRAIN_WARMUP_STEPS:
            events.append((start, end))
        check(np.isfinite(float(loss)), "real-data TONet steps: finite loss")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    ms = [a.elapsed_time(b) for a, b in events]
    return {"step_ms": float(np.median(ms)), "step_ms_all": ms, "wall_ms_per_step": 1e3 * wall}


def native_decoder_rate() -> dict:
    """The native CPU decoder (native/viterbi_native.cpp, g++ -O3
    -march=native) on the host: a NATIVE_S-state random HMM over NATIVE_T
    frames in the log domain, its states equal to the oracle's, frames/s
    (median of 3), and the host CPU's model."""
    from viterbi_spl_tpu_torch import native

    rng = np.random.default_rng(17)
    A = rng.random((NATIVE_S, NATIVE_S)) ** 4
    A /= A.sum(axis=1, keepdims=True)
    pi = np.full(NATIVE_S, 1.0 / NATIVE_S)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = np.log(rng.random((NATIVE_T, NATIVE_S)) + 1e-30).astype(np.float32)
    t0 = time.perf_counter()
    check(native.native_available(), "the native decoder builds with g++ and loads")
    build_s = time.perf_counter() - t0
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        states = native.viterbi_native_log_fn(log_B, log_pi, log_obs)
        secs.append(time.perf_counter() - t0)
    check(np.array_equal(states, viterbi_oracle_log(log_B, log_pi, log_obs)),
          "the native decoder equals the oracle")
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout.splitlines()
    cpu = next((ln.split(":", 1)[1].strip() for ln in lscpu if ln.startswith("Model name")),
               platform.machine())
    cpu = f"{cpu} ({platform.machine()}, {os.cpu_count()} cores)"
    return {"states": NATIVE_S, "frames": NATIVE_T, "build_seconds": build_s,
            "frames_per_s": NATIVE_T / float(np.median(secs)), "host_cpu": cpu}


def phase_real_data(dev, smi: str, tmp: Path) -> dict:
    """The real-data chains on a fake corpus (data/fake_corpus.py, its CFPs
    on the card; REAL_SECONDS tracks), its roots in the environment:

    - TONet at its published width: apps.tonet train --debug for
      REAL_TONET_STEPS steps on the fake MedleyDB (wav -> CFP on the card
      -> model -> loss), then, the counts set to 0 just before and read
      just after, infer --debug --external-eval (exactly K1/K2): all six
      eval sets, finite OAs, the cross-check within REAL_LOOSE_TOL; adc04's
      first track decoded on the card and on the CPU (the kernels' plain
      versions) to the same states, equal to the oracle's; the train step on
      the real-data batches with and without the native prefetch ring; the
      ring's batch stream equal to python_reference_batches.
    - msnet at its width: train --debug --native-prefetch one step (the
      ring, not the fallback), infer --debug --external-eval (exactly
      K1/K2), the cross-check within REAL_STRICT_TOL on validation, test and
      adc04.
    - imm eval --debug --external-eval --original with the full IMMConfig()
      (--debug keeps two tracks a corpus; its smaller NMF is replaced by the
      full one), counted: its viterbi method decodes through the banded
      kernels (imm's shaped matrix at 722 states is banded), its original
      method through the dense ones (K3/K4); finite OAs of the three methods
      on adc04, mirex05 and mir1k, and no rwc.
    - the native CPU decoder's frames/s on the host.
    Times printed beside the card's name and power limit."""
    import contextlib
    import io

    from viterbi_spl_tpu_torch.apps import common as AC
    from viterbi_spl_tpu_torch.apps import imm as imm_app
    from viterbi_spl_tpu_torch.apps import msnet as msnet_app
    from viterbi_spl_tpu_torch.apps import tonet as tonet_app
    from viterbi_spl_tpu_torch.cli.transcribe import features_from_samples
    from viterbi_spl_tpu_torch.data import generate_fake_corpus, medleydb_splits
    from viterbi_spl_tpu_torch.harness.train import restore_checkpoint
    from viterbi_spl_tpu_torch.models.imm import IMM, IMMConfig
    from viterbi_spl_tpu_torch.native.prefetch import SnippetPrefetcher

    rec = {"phase": "real_data", "seconds_each": REAL_SECONDS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roots = generate_fake_corpus(tmp / "corpus", duration=REAL_SECONDS,
                                 rwc_duration=REAL_SECONDS, device=dev)
    rec["corpus_ms"] = 1e3 * (time.perf_counter() - t0)
    saved = {k: os.environ.get(k) for k in roots}
    os.environ.update(roots)
    try:
        # TONet: train, then infer --external-eval, counted and timed by set
        ck = tmp / "tonet_real.pt"
        common = ["--debug", "--ckpt", str(ck)]
        t0 = time.perf_counter()
        best = tonet_app.main(["train", *common, "--epochs", "1", "--steps-per-epoch",
                               str(REAL_TONET_STEPS), "--patience", "1"])
        rec["tonet_train_main_seconds"] = time.perf_counter() - t0
        check(np.isfinite(best.best_oa) and best.step == REAL_TONET_STEPS,
              "real-data tonet train: finite validation OA after its steps")
        # app_main calls run_inference once an eval set, in REAL_EVAL_SETS' order
        inference, building = AC.run_inference, tonet_app.build_external_datasets
        AC.run_inference = _Timed(inference)
        tonet_app.build_external_datasets = _Timed(building)
        try:
            reset_counts()
            t0 = time.perf_counter()
            out = run_counted({"K1", "K2"}, "tonet infer --external-eval", tonet_app.main,
                              ["infer", *common, "--external-eval"])
            rec["tonet_infer_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["launches_tonet"] = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
            rec["tonet_infer_ms_by_set"] = {
                name: 1e3 * s for name, (_, s) in zip(REAL_EVAL_SETS, AC.run_inference.calls)}
            rec["tonet_external_datasets_ms"] = 1e3 * tonet_app.build_external_datasets.calls[0][1]
        finally:
            AC.run_inference = inference
            tonet_app.build_external_datasets = building
        rec["tonet_oa"] = check_external_infer(out, "tonet")

        # adc04's first track: the card's decode against the CPU's and the oracle
        state, _, model_kwargs = restore_checkpoint(ck)
        cfg = tonet_app.config()
        with torch.device("meta"):
            model = cfg.make_model(dtype=cfg.compute_dtype, **model_kwargs)
        model = model.to_empty(device=dev)
        AC.load_state(model, state)
        real = tonet_app.build_real_datasets(debug=True, device=dev)
        adc = AC.build_external_eval_datasets(
            lambda x: features_from_samples("tonet", x, device=dev), sr=8000,
            labels_on_10ms=True, debug=True, corpora=("adc04",))["adc04"]
        logits0 = AC.tracks_for_evaluation(cfg, model, adc)[0]["logits"]
        paths = []
        for d in (dev, "cpu"):
            setup = AC.build_decoder_setup(cfg, real["validation"], state.voicing_threshold,
                                           device=d)
            voiced, bins = setup.decode(logits0)
            paths.append(np.where(voiced, bins, setup.n_bins))
        check(np.array_equal(paths[0], paths[1]),
              "real-data tonet: adc04 track 0 decodes to the same states on the card and the CPU")
        check_oracle(setup, logits0, paths[1], "real-data tonet: adc04 track 0")
        del model

        # the train step on real-data batches, with and without the ring; the
        # ring's stream against its Python reference
        train_set = real["training"]
        model, params, stats = AC.init_model(cfg, seed=TRAIN_SEED, device=dev)
        opt = AC.make_optimizer(cfg, model, REAL_TONET_STEPS)
        step = AC.make_train_step(cfg, model)
        for key, ring in (("tonet_step", False), ("tonet_step_native_prefetch", True)):
            batches = AC.training_batches(cfg, train_set, np.random.default_rng(2), dev,
                                          native_prefetch=ring)
            rec[key] = step_times(step, params, stats, opt, batches,
                                  0 if not ring else TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)
            del batches
        del model, params, stats, opt, step
        pf = SnippetPrefetcher(train_set, cfg.snippet_len, cfg.batch_size,
                               np.random.default_rng(3))
        ref = pf.python_reference_batches(np.random.default_rng(3))
        full = sum(t.num_frames // cfg.snippet_len for t in train_set.tracks)
        n_batches = 3 * full // cfg.batch_size + 1  # three epochs and more
        ring = iter(pf)
        for _ in range(n_batches):
            (a, b), (c, d) = next(ring), next(ref)
            check(a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes(),
                  "the prefetch ring's batches equal python_reference_batches")
        pf.close()
        rec["ring_batches_checked"] = n_batches

        # msnet: one train step through the ring, infer --external-eval
        ck = tmp / "msnet_real.pt"
        common = ["--debug", "--ckpt", str(ck)]
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            msnet_app.main(["train", *common, "--epochs", "1", "--steps-per-epoch", "1",
                            "--patience", "1", "--native-prefetch"])
        print(log.getvalue(), end="", flush=True)
        check("native prefetch unavailable" not in log.getvalue(),
              "msnet --native-prefetch trained through the ring")
        reset_counts()
        t0 = time.perf_counter()
        out = run_counted({"K1", "K2"}, "msnet infer --external-eval", msnet_app.main,
                          ["infer", *common, "--external-eval"])
        rec["msnet_infer_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["launches_msnet"] = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
        rec["msnet_oa"] = check_external_infer(out, "msnet",
                                               strict=("validation", "test", "adc04"))

        # imm at the full IMMConfig on --debug's tracks, each corpus's STFTs,
        # fits and labels timed; its kernels follow from the app's matrix (the
        # shaped one from the validation labels)
        setup = imm_app.build_setup(IMM(IMMConfig(), device=dev), stats_notes=[
            imm_app._medleydb_label(t)["notes"] for t in medleydb_splits()["validation"][:2]])
        banded = VB.extract_banded_structure(setup.transition_matrix) is not None
        expect = {"K3", "K4"} | ({"K1", "K2"} if banded else set())
        del setup
        config, build_eval = imm_app.IMMConfig, AC.build_external_eval_datasets
        imm_app.IMMConfig = lambda **kw: IMMConfig()
        AC.build_external_eval_datasets = _Timed(build_eval, lambda *a, corpora, **kw: corpora[0])
        try:
            reset_counts()
            t0 = time.perf_counter()
            out = run_counted(expect, "imm eval --external-eval --original", imm_app.main,
                              ["eval", "--debug", "--external-eval", "--original"])
            rec["imm_eval_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["launches_imm"] = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
            rec["imm_fits_ms_by_corpus"] = {c: 1e3 * s for c, s in
                                            AC.build_external_eval_datasets.calls}
        finally:
            imm_app.IMMConfig, AC.build_external_eval_datasets = config, build_eval
        rec["imm_viterbi_banded"] = banded
        rec["imm_oa"] = {}
        for corpus in ("adc04", "mirex05", "mir1k"):
            res = out[corpus]
            oas = [res["raw_mean_oa"], res["viterbi_mean_oa"], res["original"]["mean_oa"]]
            rec["imm_oa"][corpus] = oas
            check(np.all(np.isfinite(oas)) and len(res["original"]["oas"]) == 2,
                  f"imm {corpus}: finite OAs of the three methods")
        check("rwc" not in out, "imm: no rwc")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    rec["native"] = native_decoder_rate()
    emit(rec)
    lines = [("corpus generation ms", f"{rec['corpus_ms']:.1f}"),
             ("TONet train step ms (Python pipeline)",
              f"{rec['tonet_step']['step_ms']:.2f} (wall {rec['tonet_step']['wall_ms_per_step']:.2f})"),
             ("TONet train step ms (--native-prefetch)",
              f"{rec['tonet_step_native_prefetch']['step_ms']:.2f} "
              f"(wall {rec['tonet_step_native_prefetch']['wall_ms_per_step']:.2f})"),
             ("TONet infer --external-eval ms", f"{rec['tonet_infer_ms']:.1f}"),
             ("TONet external front-ends ms", f"{rec['tonet_external_datasets_ms']:.1f}"),
             *((f"TONet infer ms, {name}", f"{ms:.1f}")
               for name, ms in rec["tonet_infer_ms_by_set"].items()),
             ("msnet infer --external-eval ms", f"{rec['msnet_infer_ms']:.1f}"),
             ("imm eval --external-eval --original ms", f"{rec['imm_eval_ms']:.1f}"),
             *((f"imm STFTs, fits and labels ms, {c}", f"{ms:.1f}")
               for c, ms in rec["imm_fits_ms_by_corpus"].items())]
    for what, value in lines:
        print(f"real-data phase, {smi}: {what} {value}", flush=True)
    print(f"real-data phase, host CPU {rec['native']['host_cpu']}: native decoder "
          f"{rec['native']['states']} states, frames/s {rec['native']['frames_per_s']:.0f}",
          flush=True)
    return rec


# ----------------------------------------------------------------------
# Mesh training and the multi-process runtime: TONet at its published width
# trained through apps.common._train (what app_main calls) over meshes of
# [cuda:0] * 4 against the single-device run, the mesh checkpoint's infer
# (K1/K2) with no mesh, and two processes on cuda:0 under gloo
# (dist/workers.py: the all-reduce, decode_tracks_sharded on K3/K4, tp
# training with checkpoint and resume, BatchNorm across processes).
# ----------------------------------------------------------------------

MESH_STEPS, MESH_TIMED_STEPS = 3, 3
MESH_CASES = (("data=4", 4, 1), ("data=2,model=2", 2, 2))
# each mesh run against the single-device run from the same seed on the card
# (the same weights, full batches and dropout masks): the first step's loss
# differs only by sum orders (convolutions over shares, BatchNorm's sums),
# held within MESH_FIRST_RTOL; from the first update on the runs' params
# differ by up to 2 lr where a gradient element near 0 took the other sign
# (float32 TONet gradients are ill-conditioned, PERF.md §6), so the later
# steps' losses are held within MESH_LOSS_RTOL; the BatchNorm averages
# after step 1 within TRAIN_BN_TOL (bn_error). Measured by this phase on an
# H100 80GB HBM3 at 700 W (PERF.md §6): the first step 1.1e-7 (data=4) and
# 4.5e-7 (data=2,model=2), the later steps up to 3.4e-5 and 4.1e-5, the
# BatchNorm averages 1.2e-7 and 2.4e-7; on the CPU at attn_dim 32 the later
# steps reached 7.7e-5. MESH_LOSS_RTOL is about four times the largest.
MESH_FIRST_RTOL = 1e-5
MESH_LOSS_RTOL = 3e-4
MP_CHECKS = "decode,ckpt,tp,bn"


def mesh_train_run(dev, cfg, datasets, ckpt: Path, mesh=None) -> dict:
    """TONet for one epoch of MESH_STEPS steps through apps.common._train,
    on `dev` or over `mesh`, from seed 0, batches of full-length snippets
    (a mesh's; the single run draws the same ones), each step's loss read
    as it ends and the BatchNorm averages after step 1 kept; a checkpoint
    at ckpt."""
    from viterbi_spl_tpu_torch.apps import common as AC
    from viterbi_spl_tpu_torch.dist.train import MeshOptimizer
    from viterbi_spl_tpu_torch.harness.train import Trainer, TrainState

    model, params, stats = AC.init_model(cfg, seed=0, device=dev)
    if mesh is None:
        opt = AC.make_optimizer(cfg, model, MESH_STEPS)
        step = AC.make_train_step(cfg, model)
    else:
        opt = MeshOptimizer(model, mesh, lambda ps: AC.make_optimizer(cfg, None, MESH_STEPS,
                                                                      params=ps))
        step = AC.make_mesh_train_step(cfg, opt)
    losses, bn = [], {}

    def recorded(params, batch_stats, opt_state, batch, step_i, threshold):
        out = step(params, batch_stats, opt_state, batch, step_i, threshold)
        losses.append(float(out[3]))
        if step_i == 0:
            bn.update(_host64(batch_stats))
        return out

    trainer = Trainer(recorded, AC.make_validate(cfg, model, datasets["validation"]),
                      ckpt_path=ckpt, patience_epochs=5, max_epochs=1, family="tonet")
    args = argparse.Namespace(native_prefetch=False, log_dir=None, tensorboard=False,
                              resume=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = AC._train(cfg, args, trainer, TrainState(params, stats, opt_state=opt), datasets,
                      MESH_STEPS, dev, full_batches=True)
    torch.cuda.synchronize()
    return {"state": state, "losses": losses, "bn": bn, "opt": opt, "step": step,
            "params": params, "stats": stats, "train_seconds": time.perf_counter() - t0}


def mesh_step_times(run, cfg, train_set, dev) -> dict:
    """MESH_TIMED_STEPS more steps after one warm-up, each between CUDA
    events (median ms); on a mesh, then its gradient reduction and its
    gather alone, each the median of MESH_TIMED_STEPS calls between CUDA
    events (the last step's gradients re-reduced, its values re-gathered:
    the same work as inside a step)."""
    from viterbi_spl_tpu_torch.apps import common as AC

    batches = AC.training_batches(cfg, train_set, np.random.default_rng(1), dev,
                                  full_batches=True)
    ms = []
    for s in range(1 + MESH_TIMED_STEPS):
        batch = next(batches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = run["step"](run["params"], run["stats"], run["opt"], batch, MESH_STEPS + s, 0.5)[3]
        end.record()
        end.synchronize()
        check(np.isfinite(float(loss)), "mesh: finite loss in the timed steps")
        if s:
            ms.append(start.elapsed_time(end))
    rec = {"step_ms": float(np.median(ms)), "step_ms_all": ms}
    opt = run["opt"]
    if hasattr(opt, "reduce_grads"):
        for name, fn in (("reduce_ms", opt.reduce_grads), ("gather_ms", opt.gather)):
            rec[name] = cuda_ms(fn, MESH_TIMED_STEPS)
    return rec


def phase_mesh_train(dev, smi: str, tmp: Path) -> dict:
    """Mesh training and the multi-process runtime on the card (phase 3i).
    TONet at its published width (phase 3g's configuration), batch 4 x 128
    frames, --synthetic, one epoch of MESH_STEPS steps: once on the card,
    then with data=4 and data=2,model=2 meshes over [cuda:0] * 4 (the
    machine has one card; `train --mesh` itself exits with fewer CUDA
    devices than the mesh). Checks: each step's loss against the single
    run's (the first within MESH_FIRST_RTOL, later ones within
    MESH_LOSS_RTOL), the BatchNorm averages after step 1 within
    TRAIN_BN_TOL, with model=2 the sharded leaves those of the tp rule and
    the checkpoint in the single-device layout, restored by infer with no
    mesh (counts set to 0 just before it: exactly K1/K2, finite OAs). Then
    two processes on cuda:0 under gloo (dist/workers.py): the all-reduce,
    decode_tracks_sharded on K3/K4 (each process two shares, counted in
    the process, its tracks equal to the oracle's), tp training with the
    barriered checkpoint and resume, BatchNorm across the processes. Times:
    ms per step single and on each mesh, the mesh's gradient reduction and
    gather, each beside the card's name and power limit."""
    from viterbi_spl_tpu_torch.apps import common as AC
    from viterbi_spl_tpu_torch.apps import tonet as tonet_app
    from viterbi_spl_tpu_torch.dist.tp import make_tp_mesh, tp_param_specs
    from viterbi_spl_tpu_torch.dist.workers import spawn
    from viterbi_spl_tpu_torch.harness.train import restore_checkpoint

    t_phase = time.perf_counter()
    cfg = tonet_app.config()
    datasets = dict(training=AC.synthetic_dataset(cfg, 6, 2000, 0),
                    validation=AC.synthetic_dataset(cfg, 3, 2000, 1),
                    test=AC.synthetic_dataset(cfg, 3, 2000, 2))
    single = mesh_train_run(dev, cfg, datasets, tmp / "tonet_single.pt")
    rec = {"phase": "mesh_train", "model": "tonet all/ftanet attn_dim 2048",
           "batch": cfg.batch_size, "chunk_frames": cfg.snippet_len, "steps": MESH_STEPS,
           "single": {"losses": single["losses"], "train_seconds": single["train_seconds"],
                      **mesh_step_times(single, cfg, datasets["training"], dev)}}
    single_bn, single_losses = single["bn"], single["losses"]
    del single
    for label, n_data, n_model in MESH_CASES:
        devices = [dev] * (n_data * n_model)
        mesh = (make_tp_mesh(n_data, n_model, devices) if n_model > 1
                else make_mesh(data=n_data, devices=devices))
        ckpt = tmp / f"tonet_mesh_{n_data}x{n_model}.pt"
        run = mesh_train_run(dev, cfg, datasets, ckpt, mesh)
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], single_losses)]
        bn_err = bn_error(run["bn"], single_bn)
        case = {"losses": run["losses"], "loss_rel_err": rel, "bn_err_after_step_1": bn_err,
                "train_seconds": run["train_seconds"]}
        check(len(rel) == MESH_STEPS and all(np.isfinite(run["losses"])),
              f"mesh {label}: {MESH_STEPS} finite losses")
        check(rel[0] <= MESH_FIRST_RTOL,
              f"mesh {label}: the first step's loss within {MESH_FIRST_RTOL}: {rel}")
        check(max(rel[1:]) <= MESH_LOSS_RTOL,
              f"mesh {label}: later steps' losses within {MESH_LOSS_RTOL}: {rel}")
        check(bn_err <= TRAIN_BN_TOL,
              f"mesh {label}: BatchNorm averages after step 1 within {TRAIN_BN_TOL}: {bn_err}")
        opt = run["opt"]
        if n_model > 1:
            sharded = sorted(k for k, sh in opt.store.items() if sh.spec is not None)
            want = tp_param_specs(opt.replicas[0], n_model)
            check(sharded == sorted(k for k, s in want.items() if s is not None),
                  f"mesh {label}: the sharded leaves are the tp rule's")
            case["sharded_leaves"] = len(sharded)
            case["replicated_leaves"] = sorted(set(opt.store) - set(sharded))
            ck, family, _ = restore_checkpoint(ckpt)
            check(family == "tonet" and all(
                ck.opt_state["state"][i]["exp_avg"].shape == t.shape
                for i, t in enumerate(ck.params.values())),
                f"mesh {label}: the checkpoint holds Adam's state in the single-device layout")
            reset_counts()
            t0 = time.perf_counter()
            out = run_counted({"K1", "K2"}, f"tonet infer on the {label} checkpoint",
                              tonet_app.main, ["infer", "--synthetic", "--ckpt", str(ckpt)])
            case["infer_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["launches_infer"] = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
            case["infer_oa"] = {s: [out[s]["raw_mean_oa"], out[s]["viterbi_mean_oa"]]
                                for s in ("validation", "test")}
            check(all(np.isfinite(v) for s in case["infer_oa"].values() for v in s),
                  f"mesh {label}: finite OAs from infer")
        case.update(mesh_step_times(run, cfg, datasets["training"], dev))
        rec[label] = case
        del run, opt
        torch.cuda.empty_cache()

    emit(rec)
    t0 = time.perf_counter()
    codes, outs, results = spawn(MP_CHECKS, "cuda", tmp / "multiprocess", timeout=600)
    rec["two_process_seconds"] = time.perf_counter() - t0
    check(codes == [0, 0], "two processes on cuda:0: " + "\n---\n".join(outs)[-4000:])
    rec["two_process"] = results
    for r in results:
        check(r["decode"]["launches"] == {"K3": 2, "K4": 2},
              f"two-process decode: K3/K4 twice in each process: {r['decode']['launches']}")
    rec["launches_two_process_decode"] = {
        k: sum(r["decode"]["launches"].get(k, 0) for r in results) for k in KERNEL_INFO}
    rec["phase_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "mesh_two_process", **{k: rec[k] for k in (
        "two_process_seconds", "two_process", "launches_two_process_decode", "phase_seconds")}})
    lines = [("ms per train step, single device", f"{rec['single']['step_ms']:.2f}")]
    for label, _, _ in MESH_CASES:
        case = rec[label]
        lines += [(f"ms per train step, --mesh {label} on [cuda:0] * 4",
                   f"{case['step_ms']:.2f}"),
                  (f"gradient reduction ms, {label}", f"{case['reduce_ms']:.2f}"),
                  (f"gather ms, {label}", f"{case['gather_ms']:.2f}"),
                  (f"loss rel err against single, {label}",
                   ", ".join(f"{e:.3g}" for e in case["loss_rel_err"])),
                  (f"BatchNorm averages err after step 1, {label}",
                   f"{case['bn_err_after_step_1']:.3g}")]
    lines += [("infer ms on the data=2,model=2 checkpoint",
               f"{rec['data=2,model=2']['infer_ms']:.1f}"),
              ("two processes on cuda:0 (decode, ckpt, tp, bn) seconds",
               f"{rec['two_process_seconds']:.1f}"),
              ("phase seconds", f"{rec['phase_seconds']:.1f}")]
    for what, value in lines:
        print(f"mesh phase, {smi}: {what} {value}", flush=True)
    return rec


def phase_streaming(dev) -> dict:
    """StreamingViterbiBatch at tonet 361: 64 streams, 32-frame pushes (320
    ms of audio), lag 128 and lag >= length over 4096 frames of K5's log
    observations of bench.py's serving logits; the counts set to 0 just
    before the pushes and read just after. Exactly K1/K2 launch (K1 once per
    push, K2 once per emitting push and flush); with lag >= length the
    states equal the offline decode."""
    A, pi = shaped_matrix(360, 14, 0)
    M, T, hop = 64, 4096, 32
    g = torch.Generator(device=dev).manual_seed(4)
    logits = torch.randn((M, T, 360), generator=g, device=dev).sub_(2.0)
    log_obs = OF.log_obs(logits, obs_cfg("shaun", 5, 0.0, None))
    del logits
    offline = VD.viterbi_decode_batch_logobs(transition_matrix=A, prob_init=pi, log_obs=log_obs,
                                             lengths=np.full(M, T, np.int32)).cpu().numpy()
    pushes = T // hop
    runs = {}
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    for lag in (128, T):
        pool = StreamingViterbiBatch(A, pi, M, lag=lag, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [pool.push(log_obs[:, i:i + hop], is_log=True) for i in range(0, T, hop)]
        outs.append(pool.flush())
        wall = time.perf_counter() - t0
        runs[lag] = (np.concatenate(outs, axis=1), 1e3 * wall / pushes)
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    emitting = sum(1 for lag in runs for k in range(1, pushes + 1) if k * hop > lag) + len(runs)
    agree = float(np.mean(runs[128][0] == offline))
    rec = {"phase": "streaming", "streams": M, "frames": T, "hop": hop, "lags": list(runs),
           "ms_per_push": {lag: r[1] for lag, r in runs.items()},
           "lag128_agreement_with_offline": agree, "launches": launches}
    emit(rec)
    check({k for k, n in launches.items() if n} == {"K1", "K2"}
          and launches["K1"] == 2 * pushes and launches["K2"] == emitting,
          f"streaming launched exactly K1 per push and K2 per emission: {launches}")
    check(all(r[0].shape == (M, T) for r in runs.values()), "every frame emitted once")
    check(np.array_equal(runs[T][0], offline), "streaming with lag >= length equals the offline decode")
    return rec


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the FP32 operations over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(kernel, S, lengths, bs=None):
    """(bytes, operations) of K1-K4, K7 and K8: each input and output once,
    and the FP32 operations this run's lengths need (K7 as K3, K8 as K4)."""
    frames = int(np.sum(lengths))
    steps = int(np.sum(np.asarray(lengths) - 1))
    row = 4 * S
    dense = kernel in ("K3", "K4", "K7", "K8")  # read the whole [S, S] table
    if kernel in ("K1", "K3", "K7"):
        nbytes = 2 * frames * row + (S * S * 4 if dense else 0)
        if kernel == "K1":
            n = S - 1
            inband = sum(min(bs.d_max, n - 1 - s) - max(-bs.d_max, -s) + 1 for s in range(n))
            # in-band add+max, seed (2 adds, 1 max), obs add, the voiced max
            # reduction, and the unvoiced target's 4 operations
            ops = steps * (2 * inband + 4 * n + n + 4)
        else:
            ops = steps * 2 * S * S
    else:
        nbytes = steps * row + frames * 4 + (S * S * 4 if dense else 0)
        ops = steps * 2 * S  # one add and one compare per candidate
    return nbytes, ops


def bounds(kernel, S, lengths, bs=None):
    return bound(*work(kernel, S, lengths, bs))


def obs_work(n_bins, spw, frames, peaks, softmax):
    """(bytes, operations) of K5/K6 over `frames` frames: the logits read
    and the log observations written once (and the log-prior row); per bin
    the two window maxima and the peak test (2 spw + 1), per peak of this
    run's data the exp, its sum and the output arithmetic (6)."""
    nbytes = frames * (2 * n_bins + 1) * 4 + (n_bins * 4 if softmax else 0)
    return nbytes, frames * n_bins * (2 * spw + 1) + 6 * peaks


def full_width_shapes():
    """(kind, label, N, T, (A, pi)): bench.py's headline shape, jdc's
    722-state shape, and the dense kernels at 361 and 722 states."""
    return [
        ("banded", "tonet 361", 128, 32768,
         shaped_matrix(360, hmm_params.single_side_d_max(0.01, 60), 0)),
        ("banded", "jdc 722", 64, 4096, shaped_matrix(721, 40, 1)),
        ("dense", "imm 722", 16, 4096,
         (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))),
        ("dense", "random 361", 16, 4096, dense_matrix(361, 2)),
    ]


def phase_timing(dev, shapes, base=None) -> dict:
    """Per shape: kernel ms, plain ms (short T, scaled per frame), bound;
    with a baseline, its K1 and K2 in turns at the banded shapes, and equal
    to these."""
    T_PLAIN = 32
    results = {}
    for kind, label, N, T, (A, pi) in shapes:
        S = A.shape[0]
        lengths = np.full(N, T, np.int32)
        log_obs = uniform_log_obs(N, T, S, seed=7, dev=dev)
        (fwd, bt, fwd_p, bt_p), log_B, log_pi = kernel_pair(kind, A, pi, log_obs, lengths)
        kf, kb = ("K1", "K2") if kind == "banded" else ("K3", "K4")
        iters = 5 if T * N > 1 << 20 else 10
        bs = VB.extract_banded_structure(A) if kind == "banded" else None
        old_f = base and base.forward(kind, bs, log_B, log_pi, log_obs, lengths)
        out = {}
        ms_f, ms_f_old = in_turns(lambda: out.update(f=fwd(log_obs, lengths)), old_f, iters)
        t1_last, t1m1 = out.pop("f")
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        old_b = base and base.backtrace(kind, bs, log_B, t1m1, last, lengths)
        ms_b, ms_b_old = in_turns(lambda: out.update(b=bt(t1m1, last, lengths)), old_b, iters)
        states = out.pop("b")
        if old_f:
            check(same_forward(old_f(), (t1_last, t1m1), lengths),
                  f"{label}: the baseline's {kf} gives the same t1_last and t1m1")
        if old_b:
            check(same_states(old_b(), states, lengths),
                  f"{label}: the baseline's {kb} gives the same states")
        k4 = None
        if not bs:  # K4's segments by its rule and the frames its seams re-chased
            fixups = torch.zeros(N, dtype=torch.int32, device=dev)
            VD.dense_backtrace(log_B, t1m1, last, lengths, fixups=fixups)
            k4 = {"segment": VD.k4_segment_length(N, T, VD.dense_backtrace_resident(S)),
                  "warmup": VD.K4_WARMUP, "frames_rechased": int(fixups.sum())}

        def decode():
            t1, rows = fwd(log_obs, lengths)
            return bt(rows, torch.argmax(t1, dim=1).to(torch.int32), lengths)

        del t1m1
        torch.cuda.empty_cache()
        ms_decode = cuda_ms(decode, iters)
        t0 = time.perf_counter()
        oracle = viterbi_oracle_log(log_B, log_pi, log_obs[0].cpu().numpy())
        oracle_s = time.perf_counter() - t0
        oracle_ok = bool(np.array_equal(states[0].cpu().numpy(), oracle))
        check(oracle_ok, f"{label}: full-width track 0 equals the oracle")

        short = log_obs[:, :T_PLAIN].contiguous()
        lens_s = np.full(N, T_PLAIN, np.int32)
        res = {}
        ms_fp = cuda_ms(lambda: res.update(f=fwd_p(short, lens_s)), 1) * T / T_PLAIN
        t1_s, rows_s = res["f"]
        last_s = torch.argmax(t1_s, dim=1).to(torch.int32)
        ms_bp = cuda_ms(lambda: bt_p(rows_s, last_s, lens_s), 1) * T / T_PLAIN

        bf = bounds(kf, S, lengths, bs)
        bb = bounds(kb, S, lengths, bs)
        rec = {"phase": "timing", "shape": label, "N": N, "T": T, "S": S,
               "decode_ms": ms_decode, "frames_per_s": N * T / (ms_decode / 1e3),
               f"{kf}_ms": ms_f, f"{kb}_ms": ms_b,
               f"{kf}_base_ms": ms_f_old, f"{kb}_base_ms": ms_b_old,
               f"{kf}_plain_ms": ms_fp, f"{kb}_plain_ms": ms_bp,
               f"{kf}_bound_ms": bf[0], f"{kf}_bound_by": bf[1],
               f"{kb}_bound_ms": bb[0], f"{kb}_bound_by": bb[1],
               "K2_route": bs and VB.k2_route(bs, N, T, last),
               "K1_cluster": bs and VB.k1_cluster(N, S, bs.d_max),
               "K3_route": None if bs else VD.k3_route(S),
               "K3_tracks_per_cluster": None if bs else VD.k3_tracks_per_cluster(
                   N, VD.window_max_clusters(S)),
               "K4_segments": k4,
               "voiced_share": voiced_share(states, S, lengths),
               "plain_T": T_PLAIN, "oracle_seconds": oracle_s, "track0_matches_oracle": oracle_ok}
        emit(rec)
        results[label] = rec
        del log_obs, states, short, res, out
        torch.cuda.empty_cache()
    return results


SERVING_SHAPES = (
    # label, n_bins, d_max, spw, N, T, track 0's length, seed (bench.py:209-287)
    ("tonet 361 serving", 360, 14, 5, 128, 8192, 8192, 2),
    ("jdc 722 serving", 721, 40, 16, 64, 4096, 1024, 3),
)


def phase_serving(dev, base=None) -> dict:
    """bench.py's serving chains on logits normal - 2 (threshold 0): K5 and
    K6 (scaled) alone, K5 -> K1 -> argmax -> K2, K9 -> K2, and the default
    path (the PyTorch observation model, the log, K1/K2). Checks that both
    chains decode the same states and that track 0 equals the oracle on
    K5's log observations. With a baseline, its K1, K2 and K9 in turns with
    these, and equal to them."""
    T_PLAIN = 32
    results = {}
    for label, n_bins, d_max, spw, N, T, len0, seed in SERVING_SHAPES:
        A, pi = shaped_matrix(n_bins, d_max, 0 if n_bins == 360 else 1)
        S = n_bins + 1
        bs = VB.extract_banded_structure(A)
        check(bs is not None and bs.d_max == d_max, f"{label}: banded structure at d_max {d_max}")
        log_B, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(seed)
        logits = torch.randn((N, T, n_bins), generator=g, device=dev).sub_(2.0)
        lengths = np.full(N, T, np.int32)
        lengths[0] = len0
        frames = int(lengths.sum())
        pri = np.random.default_rng(seed).random(S).astype(np.float32) + 0.1
        shaun = obs_cfg("shaun", spw, 0.0, None)
        scaled = obs_cfg("softmax-scaled", spw, 0.0, pri / pri.sum())
        iters = 5

        def argmax(t1):
            return torch.argmax(t1, dim=1).to(torch.int32)

        def chain_k5():
            t1, rows = VB.banded_forward(bs, log_pi, OF.log_obs(logits, shaun), lengths)
            return VB.banded_backtrace(bs, rows, argmax(t1), lengths)

        def chain_k9():
            t1, rows = VB.banded_forward_obs(bs, log_pi, logits, lengths, shaun)
            return VB.banded_backtrace(bs, rows, argmax(t1), lengths)

        def default_obs():
            probs = shaun_observation_probs(logits.view(-1, n_bins), 0.0, spw)
            return log_obs_fn(probs).view(N, T, S)

        def chain_default():
            t1, rows = VB.banded_forward(bs, log_pi, default_obs(), lengths)
            return VB.banded_backtrace(bs, rows, argmax(t1), lengths)

        out = {}
        ms_k5, ms_k5_old = in_turns(lambda: out.update(o=OF.log_obs(logits, shaun)),
                                    base and (lambda: base.log_obs(logits, shaun)), iters)
        log_obs = out.pop("o")
        ms_k6, ms_k6_old = in_turns(lambda: out.update(o6=OF.log_obs(logits, scaled)),
                                    base and (lambda: base.log_obs(logits, scaled)), iters)
        log_obs_6 = out.pop("o6")
        if base:
            check(torch.equal(base.log_obs(logits, shaun), log_obs)
                  and torch.equal(base.log_obs(logits, scaled), log_obs_6),
                  f"{label}: the baseline's K5 and K6 give the same bits")
        del log_obs_6
        ms_k1, ms_k1_old = in_turns(
            lambda: out.update(f=VB.banded_forward(bs, log_pi, log_obs, lengths)),
            base and (lambda: base.k1(bs, log_pi, log_obs, lengths)), iters)
        t1, rows = out.pop("f")
        last = argmax(t1)
        ms_k2, ms_k2_old = in_turns(
            lambda: out.update(b=VB.banded_backtrace(bs, rows, last, lengths)),
            base and (lambda: base.k2(bs, rows, last, lengths)), iters)
        states_k5 = out.pop("b")
        voiced = voiced_share(states_k5, S, lengths)
        if base:
            check(same_forward(base.k1(bs, log_pi, log_obs, lengths), (t1, rows), lengths)
                  and same_states(base.k2(bs, rows, last, lengths), states_k5, lengths),
                  f"{label}: the baseline's K1/K2 give the same results")
        states_k5 = states_k5.cpu().numpy()
        ms_k9, ms_k9_old = in_turns(
            lambda: out.update(f=VB.banded_forward_obs(bs, log_pi, logits, lengths, shaun)),
            base and (lambda: base.k9(bs, log_pi, logits, lengths, shaun)), iters)
        t1_9, rows_9 = out.pop("f")
        states_k9 = VB.banded_backtrace(bs, rows_9, argmax(t1_9), lengths).cpu().numpy()
        k9_exact = same_forward((t1_9, rows_9), (t1, rows), lengths)
        if base:
            check(same_forward(base.k9(bs, log_pi, logits, lengths, shaun), (t1_9, rows_9), lengths),
                  f"{label}: the baseline's K9 gives the same t1_last and t1m1")
        del rows_9, t1_9, rows
        torch.cuda.empty_cache()
        same = all(np.array_equal(states_k9[n, :L], states_k5[n, :L]) for n, L in enumerate(lengths))
        oracle_ok = bool(np.array_equal(states_k5[0, :len0], viterbi_oracle_log(
            log_B, log_pi, log_obs[0, :len0].cpu().numpy())))
        check(k9_exact and same, f"{label}: K9 -> K2 equals K5 -> K1 -> K2")
        check(oracle_ok, f"{label}: track 0 equals the oracle on K5's log observations")
        peaks_mask = OF._peaks(logits, spw)
        peaks_all = int(peaks_mask.sum())
        in_len = torch.as_tensor(np.arange(T)[None, :] < lengths[:, None], device=dev)
        peaks_len = int((peaks_mask & in_len[..., None]).sum())
        del peaks_mask, log_obs
        torch.cuda.empty_cache()

        ms_chain_k5 = cuda_ms(chain_k5, iters)
        ms_chain_k9 = cuda_ms(chain_k9, iters)
        ms_default_obs = cuda_ms(default_obs, iters)
        ms_chain_default = cuda_ms(chain_default, iters)
        torch.cuda.empty_cache()
        ms_k5_plain = cuda_ms(lambda: OF.log_obs_plain(logits, shaun), 1)
        ms_k6_plain = cuda_ms(lambda: OF.log_obs_plain(logits, scaled), 1)
        short = logits[:, :T_PLAIN].contiguous()
        lens_s = np.full(N, T_PLAIN, np.int32)
        ms_k9_plain = cuda_ms(lambda: VB.banded_forward_obs_plain(
            bs, log_pi, short, lens_s, shaun), 1) * T / T_PLAIN

        b5 = bound(*obs_work(n_bins, spw, N * T, peaks_all, False))
        b6 = bound(*obs_work(n_bins, spw, N * T, peaks_all, True))
        # K9 reads the logits of each track's frames and writes t1m1 (the
        # bytes of K5 over those frames), and does K1's and K5's operations
        _, k1_ops = work("K1", S, lengths, bs)
        o_bytes, o_ops = obs_work(n_bins, spw, frames, peaks_len, False)
        b9 = bound(o_bytes, k1_ops + o_ops)
        fps = lambda ms, n=frames: n / (ms / 1e3)  # noqa: E731
        rec = {"phase": "serving", "shape": label, "N": N, "T": T, "S": S, "spw": spw,
               "d_max": d_max, "frames": frames,
               "K5_ms": ms_k5, "K5_frames_per_s": fps(ms_k5, N * T),
               "K5_plain_ms": ms_k5_plain, "K5_bound_ms": b5[0], "K5_bound_by": b5[1],
               "K5_base_ms": ms_k5_old,
               "K6_ms": ms_k6, "K6_frames_per_s": fps(ms_k6, N * T),
               "K6_plain_ms": ms_k6_plain, "K6_bound_ms": b6[0], "K6_bound_by": b6[1],
               "K6_base_ms": ms_k6_old,
               "K9_ms": ms_k9, "K9_plain_ms": ms_k9_plain, "K9_bound_ms": b9[0],
               "K9_bound_by": b9[1], "K9_plain_T": T_PLAIN, "K9_base_ms": ms_k9_old,
               "K1_on_K5_ms": ms_k1, "K2_ms_in_chain": ms_k2,
               "K2_route": VB.k2_route(bs, N, T, last),
               "voiced_share": voiced,
               "K1_on_K5_base_ms": ms_k1_old, "K2_in_chain_base_ms": ms_k2_old,
               "chain_K5_K1_K2_ms": ms_chain_k5, "chain_K5_K1_K2_frames_per_s": fps(ms_chain_k5),
               "chain_K9_K2_ms": ms_chain_k9, "chain_K9_K2_frames_per_s": fps(ms_chain_k9),
               "default_obs_ms": ms_default_obs,
               "default_path_ms": ms_chain_default,
               "default_path_frames_per_s": fps(ms_chain_default),
               "peaks": peaks_all, "track0_length": len0,
               "track0_matches_oracle": oracle_ok, "k9_equals_k5_k1": k9_exact and same}
        emit(rec)
        results[label] = rec
        del logits, short, out, t1, last
        torch.cuda.empty_cache()
    return results


class Baseline:
    """An earlier tree's viterbi_spl_tpu_torch, imported as the package
    `vspl_baseline`: its own wrappers of K1, K2, K9 (banded_forward,
    banded_backtrace, banded_forward_obs), K3, K4 and K7 (dense_forward,
    dense_backtrace, window_forward) and K5/K6 (obs_fused.log_obs), with its
    kernels built from its own csrc/ into its own build directory. They take
    and return what this tree's wrappers do."""

    def __init__(self, tree: Path):
        """Imports the package and starts its build; load() waits for it."""
        pkg = Path(tree).resolve() / "viterbi_spl_tpu_torch"
        check((pkg / "csrc" / "viterbi_banded.cu").exists(), f"--baseline tree has {pkg}")
        spec = importlib.util.spec_from_file_location(
            "vspl_baseline", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        sys.modules["vspl_baseline"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["vspl_baseline"])
        self.cuda_lib = importlib.import_module("vspl_baseline.cuda_lib")
        vb = importlib.import_module("vspl_baseline.hmm.viterbi_banded")
        self.k1, self.k2, self.k9 = vb.banded_forward, vb.banded_backtrace, vb.banded_forward_obs
        vd = importlib.import_module("vspl_baseline.hmm.viterbi_dense")
        self.k3, self.k4, self.k7 = vd.dense_forward, vd.dense_backtrace, vd.window_forward
        self.log_obs = importlib.import_module("vspl_baseline.hmm.obs_fused").log_obs
        self.error = None
        self.thread = threading.Thread(target=self._build)
        self.thread.start()

    def _build(self) -> None:
        try:
            self.cuda_lib.build(["viterbi_banded", "viterbi_dense", "viterbi_window", "obs"])
        except Exception as e:  # re-raised by load()
            self.error = e

    def load(self) -> "Baseline":
        self.thread.join()
        if self.error is not None:
            raise RuntimeError("the baseline's kernels do not build") from self.error
        return self

    def forward(self, kind, bs, log_B, log_pi, log_obs, lengths):
        """A closure of the baseline's forward on these inputs: K1 (banded)
        or K3 (dense, its tables on the card as this tree's are)."""
        if kind == "banded":
            return lambda: self.k1(bs, log_pi, log_obs, lengths)
        lB, lpi = (torch.as_tensor(x).to(log_obs.device) for x in (log_B, log_pi))
        return lambda: self.k3(lB, lpi, log_obs, lengths)

    def backtrace(self, kind, bs, log_B, t1m1, last, lengths):
        """A closure of the baseline's backtrace on these inputs: K2
        (banded) or K4 (dense)."""
        if kind == "banded":
            return lambda: self.k2(bs, t1m1, last, lengths)
        lB = torch.as_tensor(log_B).to(t1m1.device)
        return lambda: self.k4(lB, t1m1, last, lengths)


def voiced_share(states, S, lengths) -> float:
    """The share of the decoded frames below each length at a voiced state
    (K2's chain skips its in-band scan at the unvoiced one)."""
    frames = [states[n, :L] for n, L in enumerate(np.asarray(lengths))]
    return float(torch.cat(frames).ne(S - 1).float().mean())


def same_forward(a, b, lengths) -> bool:
    """Two (t1_last, t1m1) bit-equal: t1_last, and t1m1 below each length."""
    return bool(torch.equal(a[0], b[0])) and all(
        torch.equal(a[1][n, :L], b[1][n, :L]) for n, L in enumerate(np.asarray(lengths)))


def same_states(a, b, lengths) -> bool:
    return all(torch.equal(a[n, :L], b[n, :L]) for n, L in enumerate(np.asarray(lengths)))


def in_turns(new, old, iters):
    """(ms of new, ms of old or None): with old, timed old, new, new, old and
    each the mean of its two readings; else new once."""
    if old is None:
        return cuda_ms(new, iters), None
    o1, n1, n2, o2 = (cuda_ms(f, iters) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def phase_seq_timing(dev, seq, base=None) -> dict:
    """K7 and K8 alone and the single-track decode K7 -> argmax -> K8 on the
    32768-frame tonet track of phase 3c and on an imm 722 track of 4096
    frames (uniform log observations); on the tonet track also the
    time-sharded decode: K7 and K8 over its 8 windows at the final halo
    (one launch each), one halo attempt (windows, K7, argmax, K8 and the
    certificate) at each halo the certified decode tried, and the
    certified decode from halo 64. With a baseline, its K7 in turns with
    this tree's on each track and on the windows, and equal to it."""
    T_PLAIN = 32
    imm_A = hmm_params.imm_transition_matrix(20, 721)
    cases = [("tonet 361 track", seq["A"], seq["pi"], seq["log_obs"]),
             ("imm 722 track", imm_A, np.full(722, 1.0 / 722),
              uniform_log_obs(1, 4096, 722, seed=9, dev=dev)[0])]
    results = {}
    for label, A, pi, log_obs in cases:
        T, S = log_obs.shape
        log_B, log_pi = (torch.from_numpy(x).to(dev) for x in prepare_log_params(A, pi))
        zero = np.zeros(1, np.int32)
        t1_last, t1m1 = VD.viterbi_forward(log_B, log_pi, log_obs, T)
        last = torch.argmax(t1_last)
        old_k7 = base and (lambda: base.k7(log_B, log_pi, log_obs[None], [T], [0]))
        ms_f, ms_f_old = in_turns(lambda: VD.viterbi_forward(log_B, log_pi, log_obs, T),
                                  old_k7, 5)
        if old_k7:
            check(same_forward(old_k7(), (t1_last[None], t1m1[None]), [T]),
                  f"{label}: the baseline's K7 gives the same t1_last and t1m1")
        ms_b = cuda_ms(lambda: VD.viterbi_backtrace(t1m1, log_B, last, T), 5)
        del t1m1

        def decode():
            t1, rows = VD.viterbi_forward(log_B, log_pi, log_obs, T)
            return VD.viterbi_backtrace(rows, log_B, torch.argmax(t1), T)

        ms_dec = cuda_ms(decode, 5)
        short = log_obs[None, :T_PLAIN].contiguous()
        t_one = np.array([T_PLAIN], np.int32)
        res = {}
        ms_fp = cuda_ms(lambda: res.update(f=VD.window_forward_plain(
            log_B, log_pi, short, t_one, zero)), 1) * T / T_PLAIN
        t1_s, rows_s = res["f"]
        start = torch.argmax(t1_s, dim=1)
        ms_bp = cuda_ms(lambda: VD.window_backtrace_plain(log_B, rows_s, start, t_one), 1) * T / T_PLAIN
        bf, bb = bounds("K7", S, [T]), bounds("K8", S, [T])
        rec = {"phase": "timing", "shape": label, "N": 1, "T": T, "S": S,
               "decode_ms": ms_dec, "frames_per_s": T / (ms_dec / 1e3),
               "K7_ms": ms_f, "K8_ms": ms_b, "K7_plain_ms": ms_fp, "K8_plain_ms": ms_bp,
               "K7_base_ms": ms_f_old,
               "K7_us_per_frame": 1e3 * ms_f / T, "K8_us_per_step": 1e3 * ms_b / (T - 1),
               "K7_cluster_blocks": VD.window_cluster_size(S),
               "K7_bound_ms": bf[0], "K7_bound_by": bf[1],
               "K8_bound_ms": bb[0], "K8_bound_by": bb[1], "plain_T": T_PLAIN}
        if label.startswith("tonet"):
            H = seq["halo"]
            windows, lengths, resets = block_windows(log_obs, H)
            t1_w, m_w = VD.window_forward(log_B, log_pi, windows, lengths, resets)
            st = torch.argmax(t1_w, dim=1)
            old_w = base and (lambda: base.k7(log_B, log_pi, windows, lengths, resets))
            ms_wf, ms_wf_old = in_turns(
                lambda: VD.window_forward(log_B, log_pi, windows, lengths, resets), old_w, 5)
            if old_w:
                check(same_forward(old_w(), (t1_w, m_w), lengths),
                      f"{label}: the baseline's K7 gives the same windows")
            ms_wb = cuda_ms(lambda: VD.window_backtrace(log_B, m_w, st, lengths), 5)
            del m_w, windows
            ms_attempt = {h: cuda_ms(lambda: viterbi_sharded_time_blocks(
                log_B, log_pi, log_obs, seq["mesh"], halo=h), 5)
                for h in SEQ_HALO * 2 ** np.arange(int(np.log2(H // SEQ_HALO)) + 1)}
            ms_auto = cuda_ms(lambda: viterbi_decode_time_sharded(
                log_B, log_pi, log_obs, seq["mesh"], halo=SEQ_HALO), 3)
            wf, wb = bounds("K7", S, lengths), bounds("K8", S, lengths)
            rec.update({"halo": H, "blocks": SEQ_BLOCKS,
                        "K7_windows_ms": ms_wf, "K8_windows_ms": ms_wb,
                        "K7_windows_base_ms": ms_wf_old,
                        "K7_windows_bound_ms": wf[0], "K8_windows_bound_ms": wb[0],
                        "time_sharded_ms_per_halo_attempt": {int(h): ms for h, ms in ms_attempt.items()},
                        "time_sharded_decode_ms": ms_auto,
                        "speedup_vs_single_track": ms_dec / ms_auto})
        emit(rec)
        results[label] = rec
        torch.cuda.empty_cache()
    return results


def phase_path_shapes(dev, ctx, seq, base=None) -> dict:
    """One timing per launch that the kernels line counts, at the shape that
    launch had, with its bound: {kernel: {"shapes": [...], "ms_sum",
    "bound_ms_sum", "ms_sum_base"}}. What a kernel costs the main path is
    ms_sum - bound_ms_sum. With a baseline, its K1, K2 and K9 in turns with
    these at the same launches (equal to them), else ms_sum_base is null."""
    per = {k: [] for k in KERNEL_INFO}

    def add(k, label, ms, b, ms_old=None):
        per[k].append({"shape": label, "ms": ms, "bound_ms": b[0], "bound_by": b[1],
                       "base_ms": ms_old})

    def argmax(t1):
        return torch.argmax(t1, dim=1).to(torch.int32)

    # K1/K2: the CLI's batch, once per method; K3/K4: the imm DecoderSetup's
    for kind, st, lgs, n in (("banded", ctx["cli_setups"]["shaun"], ctx["cli_logits"], 3),
                             ("dense", ctx["imm_setup"], ctx["imm_logits"], 1)):
        log_obs, lengths = padded_log_obs(st, lgs)
        (fwd, bt, _, _), _, _ = kernel_pair(kind, st.transition_matrix, st.init_probs, log_obs, lengths)
        bs = VB.extract_banded_structure(st.transition_matrix) if kind == "banded" else None
        kf, kb = ("K1", "K2") if kind == "banded" else ("K3", "K4")
        S, label = log_obs.shape[2], f"{kind} main path N={len(lengths)} T={log_obs.shape[1]}"
        log_B, log_pi = prepare_log_params(st.transition_matrix, st.init_probs)
        old_f = base and base.forward(kind, bs, log_B, log_pi, log_obs, lengths)
        out = {}
        ms_f, ms_f_old = in_turns(lambda: out.update(f=fwd(log_obs, lengths)), old_f, 5)
        t1, rows = out.pop("f")
        last = argmax(t1)
        old_b = base and base.backtrace(kind, bs, log_B, rows, last, lengths)
        ms_b, ms_b_old = in_turns(lambda: out.update(b=bt(rows, last, lengths)), old_b, 5)
        if old_f:
            check(same_forward(old_f(), (t1, rows), lengths),
                  f"{label}: the baseline's {kf} gives the same results")
        if old_b:
            check(same_states(old_b(), out.pop("b"), lengths),
                  f"{label}: the baseline's {kb} gives the same results")
        for _ in range(n):
            add(kf, label, ms_f, bounds(kf, S, lengths, bs), ms_f_old)
            add(kb, label, ms_b, bounds(kb, S, lengths, bs), ms_b_old)
    # K5/K6: the fused CLI's logits for each method, K5 also the imm
    # DecoderSetup's; K9: the fused decode API on the CLI's batch
    for lgs, setups in ((ctx["cli_logits"], [ctx["cli_setups"][m] for m in METHODS]),
                        (ctx["imm_logits"], [ctx["imm_setup"]])):
        lengths = np.array([lg.shape[0] for lg in lgs], np.int32)
        staged = np.zeros((len(lgs), lengths.max(), lgs[0].shape[1]), np.float32)
        for i, lg in enumerate(lgs):
            staged[i, : lengths[i]] = lg
        batch = torch.from_numpy(staged).to(dev)
        N, T, n_bins = batch.shape
        in_len = torch.as_tensor(np.arange(T)[None, :] < lengths[:, None], device=dev)
        for st in setups:
            obs = st.obs_config()
            softmax = obs["method"] != "shaun"
            peaks = OF._peaks(batch, obs["spw"])
            label = f"{obs['method']} N={N} T={T} bins={n_bins}"
            res = {}
            ms, ms_old = in_turns(lambda: res.update(o=OF.log_obs(batch, obs)),
                                  base and (lambda: base.log_obs(batch, obs)), 5)
            if base:
                check(torch.equal(base.log_obs(batch, obs), res["o"]),
                      f"{label}: the baseline's K5/K6 gives the same bits")
            add("K6" if softmax else "K5", label, ms,
                bound(*obs_work(n_bins, obs["spw"], N * T, int(peaks.sum()), softmax)), ms_old)
            bs = VB.extract_banded_structure(st.transition_matrix)
            if bs is not None:
                _, log_pi = prepare_log_params(st.transition_matrix, st.init_probs)
                o_bytes, o_ops = obs_work(n_bins, obs["spw"], int(lengths.sum()),
                                          int((peaks & in_len[..., None]).sum()), softmax)
                res = {}
                ms, ms_old = in_turns(
                    lambda: res.update(f=VB.banded_forward_obs(bs, log_pi, batch, lengths, obs)),
                    base and (lambda: base.k9(bs, log_pi, batch, lengths, obs)), 5)
                if base:
                    check(same_forward(base.k9(bs, log_pi, batch, lengths, obs), res["f"], lengths),
                          f"{label}: the baseline's K9 gives the same t1_last and t1m1")
                add("K9", label, ms, bound(o_bytes, work("K1", n_bins + 1, lengths, bs)[1] + o_ops),
                    ms_old)
            del peaks
    # K7/K8: the time-sharded decode's windows at each halo it tried, then
    # the seam-stress fixture's at halos 16, 32 and 64
    A_s, pi_s, obs_s, _ = make_seam_stress_hmm(SEQ_BLOCKS)
    tries = [(seq["A"], seq["pi"], seq["log_obs"], int(h)) for h in
             SEQ_HALO * 2 ** np.arange(int(np.log2(seq["halo"] // SEQ_HALO)) + 1)]
    tries += [(A_s, pi_s, log_obs_fn(torch.from_numpy(obs_s).to(dev)), h) for h in (16, 32, 64)]
    for A, pi, log_obs, H in tries:
        log_B, log_pi = (torch.from_numpy(x).to(dev) for x in prepare_log_params(A, pi))
        windows, lengths, resets = block_windows(log_obs, H)
        S, label = A.shape[0], f"{SEQ_BLOCKS} windows W={windows.shape[1]} S={A.shape[0]} halo {H}"
        out = {}
        add("K7", label, cuda_ms(lambda: out.update(f=VD.window_forward(
            log_B, log_pi, windows, lengths, resets)), 5), bounds("K7", S, lengths))
        t1, rows = out.pop("f")
        add("K8", label, cuda_ms(lambda: VD.window_backtrace(log_B, rows, argmax(t1), lengths), 5),
            bounds("K8", S, lengths))
    torch.cuda.empty_cache()
    res = {k: {"launches_timed": len(v), "ms_sum": sum(e["ms"] for e in v),
               "bound_ms_sum": sum(e["bound_ms"] for e in v),
               "ms_sum_base": (sum(e["base_ms"] for e in v)
                              if v and all(e["base_ms"] is not None for e in v) else None),
               "shapes": v} for k, v in per.items()}
    emit({"phase": "path_shapes", **res})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="tree of an earlier commit whose K1-K7 and K9 phases 4-4d "
                         "time beside these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    check(Path(viterbi_spl_tpu_torch.__file__).resolve().parent.parent == here,
          "the port package beside this script is the one imported")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    base = Baseline(args.baseline) if args.baseline else None  # builds beside these
    logs = cuda_lib.build()
    base = base and base.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": build_s, "ptxas": ptxas})

    errs = {k: 0.0 for k in KERNEL_INFO}
    errs["K9_vs_K5K6_K1"] = 0.0
    phase_equality(dev, errs)
    phase_obs_equality(dev, errs)
    phase_window_equality(dev, errs)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ctx = phase_main_path(dev, errs, Path(tmp))
        fused_launches = phase_fused_path(dev, errs, ctx)
        seq_launches, seq = phase_seq_path(dev, errs, ctx)
        transcribe = phase_transcribe(dev, Path(tmp))
        hi = {"dcnet": phase_dcnet(dev, errs, Path(tmp)), "imm": phase_imm(dev, errs, Path(tmp))}
        train = phase_train(dev, smi, Path(tmp))
        real = phase_real_data(dev, smi, Path(tmp))
        mesh_train = phase_mesh_train(dev, smi, Path(tmp))
    # each kernel's count from the path it belongs to
    launches.update({k: fused_launches[k] for k in ("K5", "K6", "K9")})
    launches.update({k: seq_launches[k] for k in ("K7", "K8")})
    phase_streaming(dev)
    timing = phase_timing(dev, full_width_shapes(), base)
    timing.update(phase_serving(dev, base))
    timing.update(phase_seq_timing(dev, seq, base))
    path = phase_path_shapes(dev, ctx, seq, base)
    check(all(path[k]["launches_timed"] == launches[k] for k in KERNEL_INFO),
          f"phase 4d timed one launch per counted launch: {launches}")

    headline = {"K1": "tonet 361", "K2": "tonet 361", "K3": "imm 722", "K4": "imm 722",
                "K5": "tonet 361 serving", "K6": "tonet 361 serving", "K9": "tonet 361 serving",
                "K7": "tonet 361 track", "K8": "tonet 361 track"}
    kernels = []
    for k, (name, source, replaces) in KERNEL_INFO.items():
        def entry(rec):
            return {"shape": f"{rec['shape']} N={rec['N']} T={rec['T']}",
                    "ms": rec[f"{k}_ms"], "plain_ms": rec[f"{k}_plain_ms"],
                    "bound_ms": rec[f"{k}_bound_ms"], "bound_by": rec[f"{k}_bound_by"],
                    **({"base_ms": rec[f"{k}_base_ms"]} if f"{k}_base_ms" in rec else {})}
        main_rec = timing[headline[k]]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k], "max_abs_err": errs[k],
            **entry(main_rec), "library_ms": None,
            "launches_on_fused_path": fused_launches[k],
            "launches_on_transcribe_path": transcribe["launches"][k],
            "launches_on_44k_paths": {name: rec["launches"][k] for name, rec in hi.items()},
            "launches_on_train_path": {"infer": train["launches"][k],
                                       "sweep_obs": train["launches_sweep_obs"][k]},
            "launches_on_real_data_path": {"tonet_infer_external": real["launches_tonet"][k],
                                           "msnet_infer_external": real["launches_msnet"][k],
                                           "imm_eval_external": real["launches_imm"][k]},
            "launches_on_mesh_path": {
                "infer_mesh_checkpoint": mesh_train["launches_infer"][k],
                "two_process_decode": mesh_train["launches_two_process_decode"][k]},
            "path_ms_sum": path[k]["ms_sum"], "path_bound_ms_sum": path[k]["bound_ms_sum"],
            "path_ms_sum_base": path[k]["ms_sum_base"],
            "other_shapes": [entry(r) for lbl, r in timing.items()
                             if lbl != headline[k] and f"{k}_ms" in r],
        })
        if k == "K9":
            kernels[-1]["max_abs_err_vs_k5k6_k1"] = errs["K9_vs_K5K6_K1"]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
