"""Exact banded fast path for the batched Viterbi decode (counterpart of
viterbi_spl_tpu/hmm/viterbi_banded.py): the host-side structure extraction
in NumPy, and kernels K1 (forward), K2 (backtrace: a backpointer pass, then
a chase) and K9 (the forward with the observation model computed inside it,
from raw logits) — CUDA C++ in csrc/viterbi_banded.cu, each with its plain
PyTorch version here (banded_backpointers_plain is the plain version of
K2's pass). K1 runs one block per track, or a thread-block cluster per
track where the band does not fit one thread's registers (k1_cluster).

Every shaped melody transition matrix (SURVEY.md §2.4) has the structure

    A[i, j] = banded Toeplitz-ish voiced block (|i-j| <= d_max, all > 0)
    A[i, n]   = c_vu           (voiced -> unvoiced, constant)
    A[n, j]   = c_uv           (unvoiced -> voiced, constant)
    A[n, n]   = c_uu           (n = n_bins, the unvoiced state)
    A elsewhere = exactly 0  -> log(0 + tiny) = LOG_TINY, a constant.

The dense max over sources then decomposes EXACTLY (bitwise — fp addition
is monotone and the constant adds commute with max) into:

    max( in-band candidates  T1[s+d] + log A[s+d, s], |d| <= d_max,
         T1[unvoiced] + log c_uv,
         out-of-band floor:  GLOBAL_voiced_max + LOG_TINY )

(the floor is exact even though it over-covers in-band sources: when the
global argmax a lies in the band of target s, f32(T1[a] + LOG_TINY) <=
f32(T1[a] + band[a-s]) by fp-add monotonicity). The backtrace rebuilds the
row logB[s, :] it needs from the same pieces:

    row[x] = bv[class(x - s)][x]  for |x - s| <= d_max   (in-band)
             LOG_TINY             for |x - s| >  d_max   (out of band)
             log_c_uv             at x = n_bins          (unvoiced source)
    row    = logB[n_bins, :]      when s is the unvoiced state

where bv are the source profiles of extract_band_classes: classes merge
only f32-identical profiles, so every value is the dense table's own.

The TPU layout (lanes padded to 128, shift-doubling windows over rolled
lanes) is not part of the contract: `pad_to` is kept so that the fields
compare equal to the JAX package's, and the decoders here use pad_to = S.

Reference semantics anchor: dcnet/tf_viterbi_decoding.py:156-207.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import cuda_lib, tracing
from . import obs_fused
from .viterbi import NEG_PAD, TINY, first_argmax

LOG_TINY = float(np.log(TINY))


@dataclasses.dataclass(frozen=True)
class BandedStructure:
    d_max: int
    n_bins: int
    S: int  # n_bins + 1
    P: int  # padded lanes
    band: np.ndarray  # [2*d_max+1, P] f32: band[d + d_max][s] = log A[s+d, s]
    log_c_uv: float  # log(A[n, j] + tiny)  (unvoiced -> voiced)
    log_c_vu: float  # log(A[i, n] + tiny)  (voiced -> unvoiced)
    log_c_uu: float  # log(A[n, n] + tiny)
    # source-profile classes (see extract_band_classes): each entry is
    # (offsets, kind, d_lo, d_hi) with kind 'win' or 'rolls' — the TPU
    # kernel's execution strategy, kept so the fields equal the JAX ones
    classes: tuple = ()
    bv: np.ndarray | None = None  # [len(classes), P] f32 source profiles

    def class_of_offset(self) -> np.ndarray:
        """[2*d_max+1] int32: the class index of each offset d (+ d_max)."""
        cls = np.full(2 * self.d_max + 1, -1, np.int32)
        for ci, (offsets, _, _, _) in enumerate(self.classes):
            for d in offsets:
                cls[d + self.d_max] = ci
        return cls


def extract_banded_structure(A: np.ndarray, pad_to: int | None = None) -> BandedStructure | None:
    """Detect the banded+constant-coupling structure; None if absent.
    pad_to defaults to S (no padding)."""
    A = np.asarray(A, np.float32)
    S = A.shape[0]
    n = S - 1
    if S < 3 or A.shape != (S, S):
        return None
    if not (np.all(A[:n, n] == A[0, n]) and np.all(A[n, :n] == A[n, 0])):
        return None
    voiced = A[:n, :n]
    i, j = np.ogrid[:n, :n]
    nz = voiced != 0
    if not nz.any():
        return None
    d_abs = np.abs(j - i)
    d_max = int(d_abs[nz].max())
    if d_max >= n - 1:
        return None  # effectively dense
    if np.any(voiced[d_abs > d_max] != 0.0):
        return None
    if np.any(voiced[d_abs <= d_max] == 0.0):
        return None  # zeros inside the band would break the floor identity

    P = S if pad_to is None else pad_to
    band = np.full((2 * d_max + 1, P), NEG_PAD, np.float32)
    for d in range(-d_max, d_max + 1):
        # band row holds log A[s+d, s] at lane s (the TRANSPOSED direction)
        s = np.arange(n)
        src = s + d
        ok = (src >= 0) & (src < n)
        vals = np.full(n, NEG_PAD, np.float32)
        vals[ok] = np.log(voiced[src[ok], s[ok]] + TINY)
        band[d + d_max, :n] = vals
    classes, bv = extract_band_classes(band, d_max, n, P)
    return BandedStructure(
        d_max=d_max,
        n_bins=n,
        S=S,
        P=P,
        band=band,
        log_c_uv=float(np.log(A[n, 0] + TINY)),
        log_c_vu=float(np.log(A[0, n] + TINY)),
        log_c_uu=float(np.log(A[n, n] + TINY)),
        classes=classes,
        bv=bv,
    )


def _doubling_stages(w: int) -> int:
    stages, cover = 0, 1
    while cover < w:
        cover += min(cover, w - cover)
        stages += 1
    return stages


def extract_band_classes(
    band: np.ndarray, d_max: int, n: int, P: int
) -> tuple[tuple, np.ndarray]:
    """Partition band offsets into source-profile classes (a copy of the JAX
    package's, execution strategy included).

    A per-offset source profile is pf_d[x] = band[d + d_max][x - d]
    (= log A[x, x-d], NaN where x is not a valid source). The shaping
    pipeline pools transition counts by distance and floors small counts,
    then normalizes each row by Z_x, so pf_d[x] = log(c(d)/Z_x + tiny)
    depends on d only through the pooled count. Offsets whose profiles are
    f32-identical on their common domain merge into one class with a merged
    profile.

    The 'rolls'/'win' strategy is the TPU kernel's (one lane roll per
    offset, or one shift-doubling window max over [d_lo, d_hi] when every
    non-member offset in the span dominates the profile); the CUDA kernels
    read each offset's profile directly and ignore it.

    Returns (classes, bv): classes a tuple of (offsets, kind, d_lo, d_hi),
    bv a [len(classes), P] f32 array of profiles (NEG_PAD where x is never
    a valid source for the class).
    """
    profiles = np.full((2 * d_max + 1, P), np.nan, np.float32)
    for d in range(-d_max, d_max + 1):
        s = np.arange(max(0, -d), min(n, n - d))  # valid targets
        profiles[d + d_max, s + d] = band[d + d_max, s]

    # greedy partition by exact f32 equality on the common valid domain
    class_offsets: list[list[int]] = []
    class_profiles: list[np.ndarray] = []
    for d in range(-d_max, d_max + 1):
        pf = profiles[d + d_max]
        placed = False
        for ci, cp in enumerate(class_profiles):
            both = ~np.isnan(cp) & ~np.isnan(pf)
            if both.any() and np.array_equal(cp[both], pf[both]):
                new = np.isnan(cp) & ~np.isnan(pf)
                cp[new] = pf[new]
                class_offsets[ci].append(d)
                placed = True
                break
        if not placed:
            class_offsets.append([d])
            class_profiles.append(pf.copy())

    classes: list[tuple] = []
    bvs: list[np.ndarray] = []
    for offsets, cp in zip(class_offsets, class_profiles):
        d_lo, d_hi = min(offsets), max(offsets)
        w = d_hi - d_lo + 1
        cost_rolls = 1 + sum(1 if d == 0 else 2 for d in offsets)
        cost_win = 2 + (1 if d_lo != 0 else 0) + 2 * _doubling_stages(w)
        win_ok = cost_win < cost_rolls
        if win_ok:
            # domination check for span offsets outside the class
            member = set(offsets)
            for d2 in range(d_lo, d_hi + 1):
                if d2 in member:
                    continue
                pf2 = profiles[d2 + d_max]
                both = ~np.isnan(cp) & ~np.isnan(pf2)
                if not np.all(pf2[both] >= cp[both]):
                    win_ok = False
                    break
        kind = "win" if win_ok else "rolls"
        classes.append((tuple(offsets), kind, d_lo, d_hi))
        out = np.full(P, NEG_PAD, np.float32)
        ok = ~np.isnan(cp)
        out[ok] = cp[ok]
        bvs.append(out)
    bv_arr = np.stack(bvs) if bvs else np.zeros((0, P), np.float32)
    return tuple(classes), bv_arr


# ----------------------------------------------------------------------
# Plain PyTorch versions of K1 and K2: vectorised over tracks and states,
# a Python loop over frames; the same candidates, adds and tie rule as the
# kernels. They run on the CPU, and on the GPU only to check the kernels.
# ----------------------------------------------------------------------


def banded_profiles(bs: BandedStructure, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(bv [classes, S] f32, cls [2 d_max + 1] int32): the source profiles
    and each offset's class, uploaded to `device`."""
    if bs.bv is None or not bs.classes:
        raise ValueError("banded structure carries no source-profile classes")
    bv = tracing.upload(np.ascontiguousarray(bs.bv[:, : bs.S]), device, "decode")
    cls = tracing.upload(bs.class_of_offset(), device, "decode")
    return bv, cls


def banded_forward_plain(bs: BandedStructure, log_pi, log_obs, lengths):
    """K1's plain version: log_obs [N, T, S] f32, log_pi [S], lengths [N].
    Returns (t1_last [N, S], t1m1 [N, T, S]); t1m1[:, t] = T1[t-1] (row 0
    zeros), and each track's carry freezes at its last frame."""
    N, T, S = log_obs.shape
    n, d_max = bs.n_bins, bs.d_max
    dev = log_obs.device
    bv, cls = banded_profiles(bs, dev)
    cls = cls.tolist()
    bv = bv[:, :n]
    lengths = torch.as_tensor(lengths, device=dev)
    prev = log_pi.to(dev)[None, :] + log_obs[:, 0]
    t1m1 = torch.zeros_like(log_obs)
    for t in range(1, T):
        t1m1[:, t] = prev
        voiced, prev_uv = prev[:, :n], prev[:, n]
        max_voiced = voiced.amax(dim=1)
        h = voiced[:, None, :] + bv[None]  # h[c][x] = T1[x] + bv[c][x]
        seed = torch.maximum(max_voiced + LOG_TINY, prev_uv + bs.log_c_uv)
        acc = seed[:, None].expand(N, n).clone()
        for d in range(-d_max, d_max + 1):
            hc = h[:, cls[d + d_max]]
            if d >= 0:  # targets s < n - d take source s + d
                acc[:, : n - d] = torch.maximum(acc[:, : n - d], hc[:, d:])
            else:
                acc[:, -d:] = torch.maximum(acc[:, -d:], hc[:, : n + d])
        m_uv = torch.maximum(max_voiced + bs.log_c_vu, prev_uv + bs.log_c_uu)
        new = torch.cat([acc, m_uv[:, None]], dim=1) + log_obs[:, t]
        prev = torch.where((t < lengths)[:, None], new, prev)
    return prev, t1m1


def rebuilt_rows(bs: BandedStructure, device) -> torch.Tensor:
    """[S targets, S sources] f32: row s is logB[s, :] rebuilt from the
    structure (profile values in band, LOG_TINY out of band, log c_uv at the
    unvoiced source; the uv row for the unvoiced target), the values the
    kernels use."""
    S, n, d_max = bs.S, bs.n_bins, bs.d_max
    bv, cls = banded_profiles(bs, device)
    x = torch.arange(S, device=device)[None, :]
    s = torch.arange(S, device=device)[:, None]
    e = x - s  # offset of source x from target s
    in_band = (e.abs() <= d_max) & (x < n)
    c = cls[(e + d_max).clamp(0, 2 * d_max)]
    row = torch.where(in_band, bv[c, x], LOG_TINY)
    row = torch.where(x == n, bs.log_c_uv, row)
    uv_row = torch.where(x < n, bs.log_c_vu, bs.log_c_uu).to(torch.float32)
    return torch.where(s == n, uv_row, row)


def banded_backtrace_plain(bs: BandedStructure, t1m1, last_states, lengths):
    """K2's plain version: t1m1 [N, T, S], last_states [N], lengths [N] ->
    states [N, T] int32 (zeros at or beyond each track's length)."""
    N, T, S = t1m1.shape
    dev = t1m1.device
    rows = rebuilt_rows(bs, dev)
    lengths = torch.as_tensor(lengths, device=dev)
    last = torch.as_tensor(last_states, device=dev).to(torch.int64)
    states = torch.zeros((N, T), dtype=torch.int32, device=dev)
    s = last.clone()
    for t in range(T - 1, -1, -1):
        s = torch.where(t == lengths - 1, last, s)
        active = t < lengths
        states[:, t] = torch.where(active, s, 0).to(torch.int32)
        bp = first_argmax(t1m1[:, t] + rows[s], dim=1)
        s = torch.where(active, bp, s)
    return states


def banded_backpointers_plain(bs: BandedStructure, t1m1, lengths):
    """The plain version of K2's backpointer pass: bp[n, t, s] =
    first-argmax_x(t1m1[n, t, x] + logB[s, x]) over the rebuilt rows for
    1 <= t < lengths[n], zeros elsewhere; [N, T, S] int32. Chasing s_{t-1} =
    bp[n, t, s_t] from each track's last state gives banded_backtrace_plain's
    states."""
    N, T, S = t1m1.shape
    dev = t1m1.device
    rows = rebuilt_rows(bs, dev)
    lengths = torch.as_tensor(lengths, device=dev)
    bp = torch.zeros((N, T, S), dtype=torch.int32, device=dev)
    for t in range(1, T):
        cand = t1m1[:, t, None, :] + rows[None]  # [N, S targets, S sources]
        bp[:, t] = torch.where((t < lengths)[:, None], first_argmax(cand, dim=2), 0).to(torch.int32)
    return bp


# ----------------------------------------------------------------------
# Kernel wrappers: the plain version for a CPU tensor, the CUDA kernel for
# a CUDA tensor (or an error); `launches` counts the kernel launches.
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vspl_banded_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _F, _F, _F, _P],
    "vspl_banded_backtrace": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _F, _F, _F, _P],
    "vspl_banded_forward_obs": [_P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P, _P, _P,
                                _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    "vspl_banded_forward_cluster": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _F, _F, _F, _F, _P],
}


def bp_row_entries(S: int) -> int:
    """Entries of one row of K2's int16 backpointer scratch: S rounded up to
    a multiple of 8, so that each row is a multiple of 16 bytes (the chase's
    bulk copies)."""
    return -(-S // 8) * 8


# K2's routes' costs a frame on an H100 (scripts/gpu_banded_probe.py, parts
# routes and voicing; PERF.md). The pass and the chase: K2_PASS_US plus
# K2_PASS_PS per track, target and in-band offset. The chain, whatever the
# number of tracks up to one wave: K2_CHAIN_US[S] at an unvoiced state, and
# K2_CHAIN_VOICED_US[S] more at a voiced one (its in-band scan; concave in
# the voiced share at 361 states, linear at 722), taken linearly in S
# between and beyond the two state counts measured. Both
# routes' fixed costs are ~0.08 ms, so T does not move the choice; it
# enters through the pass's scratch, which is capped.
K2_PASS_US = 0.055
K2_PASS_PS = 0.366
K2_CHAIN_US = {361: 0.50, 722: 0.66}
K2_CHAIN_VOICED_US = {361: 0.125, 722: 0.28}
K2_PASS_MAX_SCRATCH = 4 << 30


def _at_states(table: dict, S: int) -> float:
    (s0, v0), (s1, v1) = sorted(table.items())
    return v0 + (S - s0) * (v1 - v0) / (s1 - s0)


def k2_takes_pass(N: int, T: int, S: int, d_max: int, voiced: float) -> bool:
    """Whether K2 takes the backpointer pass and the chase rather than one
    chain per track, for N tracks of T frames whose paths are at a voiced
    state for a share `voiced` of their frames: while the pass's estimated
    time a frame is below the chain's, and the int16 scratch, N * T *
    bp_row_entries(S) * 2 bytes, stays within K2_PASS_MAX_SCRATCH (4 GiB).
    Both routes give the same states."""
    if 2 * N * T * bp_row_entries(S) > K2_PASS_MAX_SCRATCH:
        return False
    pass_us = K2_PASS_US + 1e-6 * K2_PASS_PS * N * S * (2 * d_max + 1)
    chain_us = _at_states(K2_CHAIN_US, S) + voiced * _at_states(K2_CHAIN_VOICED_US, S)
    return pass_us < chain_us


def k2_route(bs: BandedStructure, N: int, T: int, last_states) -> str:
    """K2's route for a batch: "pass" or "chain" by k2_takes_pass. Where
    the answer depends on the paths' voiced share, it is estimated by the
    last states' (read from the card: one wait for the forward before K2
    launches, a `decode.wait` span)."""
    lo, hi = (k2_takes_pass(N, T, bs.S, bs.d_max, v) for v in (0.0, 1.0))
    if lo == hi:
        return "pass" if lo else "chain"
    voiced = float(tracing.to_host(torch.as_tensor(last_states).ne(bs.n_bins).float().mean(),
                                   "decode"))
    return "pass" if k2_takes_pass(N, T, bs.S, bs.d_max, voiced) else "chain"


def k9_layout(S: int, model: int) -> tuple[int, int]:
    """K9's (producer warps, ring frames) at S states, by a fixed rule. One
    producer warp makes one observation frame in ~7,200 SM cycles at 361
    states (spw 5) and ~17,900 at 722 (spw 16), shaun and softmax alike,
    while the DP takes a frame in ~1,150 and ~8,300 (the DP needs one frame
    per frame); 12 producers at up to 384 states and 6 above measured
    fastest or within noise of it (scripts/gpu_banded_probe.py, PERF.md).
    The ring holds at least as many frames as there are producers (the
    kernel's parity waits need it). `model` does not change the rule."""
    dp_warps = -(-S // 32)
    producers = max(1, min(12 if S <= 384 else 6, 32 - dp_warps))
    return producers, max(producers, 32 if S <= 384 else 16)


# K1's cluster kernel (csrc/viterbi_banded.cu, banded_cluster_kernel): at
# most 384 threads a block, 8 blocks a cluster, 32 warps a cluster, a band
# of 2 d_max + 1 <= 84 offsets in registers. Its st.async exchange costs more
# a frame than one block's barrier (0.68-0.82 us a frame at 361 states
# against 0.61-0.64 for one block per track, at 8-256 tracks), so it is
# taken only where one block per track cannot hold the band in registers
# (2 d_max + 1 > 32): there the one-block kernel reads three values a
# candidate (4.2-4.3 us a frame at jdc's 722 states, d_max 40, against
# 0.83-1.14 for clusters of 2-8 blocks while N C <= the SMs).
# scripts/gpu_banded_probe.py --parts k1layouts; PERF.md.
K1_REG_BAND = 32
K1_WIDE_BAND = 84
K1_CLUSTER_THREADS = 384


def k1_cluster_fits(S: int, d_max: int, C: int) -> bool:
    """Whether the cluster kernel takes C blocks a track at (S, d_max): each
    block owns ceil(S / C) targets, one thread each (at most 384 threads,
    32 warps over the cluster), every block owns a target, and a halo comes
    from the neighbouring blocks only."""
    chunk = -(-S // C)
    threads = -(-chunk // 32) * 32
    return (1 <= C <= 8 and threads <= K1_CLUSTER_THREADS and (C - 1) * chunk < S
            and (C == 1 or chunk >= d_max) and C * threads // 32 <= 32
            and 2 * d_max + 1 <= K1_WIDE_BAND)


def k1_cluster(N: int, S: int, d_max: int, sms: int = 132) -> int:
    """K1's layout for N tracks at S states on a card of `sms` SMs: 0 for
    one block per track while its band column fits its registers (2 d_max
    + 1 <= 32) or no cluster fits; else the cluster kernel, with C blocks a
    track, C the largest of 8, 4, 2 that fits and keeps N C <= sms (one
    block an SM), or the smallest that fits when none does."""
    if 2 * d_max + 1 <= K1_REG_BAND:
        return 0
    fits = [C for C in (2, 4, 8) if k1_cluster_fits(S, d_max, C)]
    if not fits:
        return 0
    wave = [C for C in fits if N * C <= sms]
    return max(wave) if wave else min(fits)


def banded_forward(bs: BandedStructure, log_pi, log_obs: torch.Tensor, lengths,
                   cluster: int | None = None, profiles=None, lens_d=None):
    """K1: banded batched forward DP. Same contract as banded_forward_plain;
    on the GPU, rows of t1m1 at or beyond a track's length are left
    unwritten (the backtrace never reads them). cluster: the layout (0: one
    block per track; C >= 1: a cluster of C blocks per track); None takes
    k1_cluster's. On the card, profiles (banded_profiles' pair) and lens_d
    (the lengths as an int32 tensor, the same values) are taken where given
    instead of uploaded, as is log_pi where it is on the card."""
    N, T, S = log_obs.shape
    if S != bs.S:
        raise ValueError(f"log_obs has {S} states, the structure {bs.S}")
    lens = cuda_lib.host_lengths(lengths, N, T)
    if log_obs.device.type == "cpu":
        return banded_forward_plain(bs, torch.as_tensor(log_pi), log_obs, lens)
    dev = cuda_lib.cuda_operand(log_obs, "log_obs").device
    bv, cls = banded_profiles(bs, dev) if profiles is None else profiles
    lens_d = cuda_lib.card_lengths(lens, dev, lens_d)
    log_pi = tracing.upload(log_pi, dev, "decode", torch.float32).contiguous()
    t1m1 = torch.empty_like(log_obs)
    t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("viterbi_banded", _SIGNATURES)
    P = cuda_lib.ptr
    C = k1_cluster(N, S, bs.d_max, torch.cuda.get_device_properties(dev).multi_processor_count
                   ) if cluster is None else cluster
    if C:
        rc = lib.vspl_banded_forward_cluster(
            P(log_obs), P(bv), P(cls), P(log_pi), P(lens_d), P(t1m1), P(t1_last),
            N, T, S, bs.d_max, C, LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu,
            cuda_lib.stream_ptr(dev),
        )
    else:
        rc = lib.vspl_banded_forward(
            P(log_obs), P(bv), P(cls), P(log_pi), P(lens_d), P(t1m1), P(t1_last),
            N, T, S, bs.d_max, bv.shape[0], LOG_TINY, bs.log_c_uv, bs.log_c_vu,
            bs.log_c_uu, cuda_lib.stream_ptr(dev),
        )
    cuda_lib.check(lib, rc, f"banded forward (K1, cluster {C})")
    banded_forward.launches += 1
    return t1_last, t1m1


def banded_backtrace(bs: BandedStructure, t1m1: torch.Tensor, last_states, lengths,
                     route: str | None = None, profiles=None, lens_d=None):
    """K2: banded batched reverse chase. Returns states [N, T] int32;
    entries at or beyond each track's length are unspecified. On the card,
    by route "pass", a parallel pass writes every backpointer into an int16
    scratch [N, T, bp_row_entries(S)], then one thread per track chases
    them (two kernels, one counted launch); by route "chain", one warp per
    track takes each step's argmax. None takes k2_route's choice.
    profiles, lens_d: as banded_forward's."""
    N, T, S = t1m1.shape
    if S != bs.S:
        raise ValueError(f"t1m1 has {S} states, the structure {bs.S}")
    if route not in (None, "pass", "chain"):
        raise ValueError(f"K2 has the routes 'pass' and 'chain', not {route!r}")
    lens = cuda_lib.host_lengths(lengths, N, T)
    if t1m1.device.type == "cpu":
        return banded_backtrace_plain(bs, t1m1, last_states, lens)
    dev = cuda_lib.cuda_operand(t1m1, "t1m1").device
    bv, cls = banded_profiles(bs, dev) if profiles is None else profiles
    lens_d = cuda_lib.card_lengths(lens, dev, lens_d)
    last = torch.as_tensor(last_states).to(dev, torch.int32).contiguous()
    states = torch.empty((N, T), dtype=torch.int32, device=dev)
    bp = None
    if (route or k2_route(bs, N, T, last)) == "pass":
        bp = torch.empty((N, T, bp_row_entries(S)), dtype=torch.int16, device=dev)
    lib = cuda_lib.load("viterbi_banded", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_banded_backtrace(
        P(t1m1), P(bv), P(cls), P(last), P(lens_d), P(states), None if bp is None else P(bp),
        N, T, S, bs.d_max, bv.shape[0], LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "banded backtrace (K2)")
    banded_backtrace.launches += 1
    return states


def banded_forward_obs_plain(bs: BandedStructure, log_pi, logits, lengths, obs: dict):
    """K9's plain version: the plain observation model the obs dict names
    (hmm/obs_fused.py), then K1's plain version."""
    log_obs = obs_fused.log_obs_plain(logits, obs)
    return banded_forward_plain(bs, torch.as_tensor(log_pi).to(logits.device), log_obs, lengths)


def banded_forward_obs(bs: BandedStructure, log_pi, logits: torch.Tensor, lengths, obs: dict,
                       profiles=None, lens_d=None):
    """K9: the banded batched forward DP with the observation model computed
    inside it (counterpart of viterbi_forward_pallas_banded_batch_obs):
    raw logits [N, T, n_bins] f32 and the JAX package's obs dict (see
    hmm/obs_fused.py::obs_params). Returns (t1_last, t1m1) as K1 does fed
    with K5/K6's output — on the GPU bit for bit. profiles, lens_d and
    log_pi: as banded_forward's; the observation model's index map and
    log-prior row are uploaded once a device (obs_fused's card tables)."""
    N, T, n_bins = logits.shape
    if n_bins + 1 != bs.S:
        raise ValueError(f"logits have {n_bins} bins, the structure {bs.S - 1}")
    lens = cuda_lib.host_lengths(lengths, N, T)
    if logits.device.type == "cpu":
        return banded_forward_obs_plain(bs, torch.as_tensor(log_pi), logits, lens, obs)
    dev = cuda_lib.cuda_operand(logits, "logits").device
    model, spw, params, log_prior = obs_fused.obs_params(obs, n_bins)
    if bs.S > 768:
        raise ValueError(f"K9 takes at most 768 states, got {bs.S}")
    idx = obs_fused.device_table(obs_fused.reflect_index(n_bins, spw), dev, "decode")
    prior = obs_fused.device_table(log_prior, dev, "decode")
    bv, cls = banded_profiles(bs, dev) if profiles is None else profiles
    lens_d = cuda_lib.card_lengths(lens, dev, lens_d)
    log_pi = tracing.upload(log_pi, dev, "decode", torch.float32).contiguous()
    t1m1 = torch.empty((N, T, bs.S), dtype=torch.float32, device=dev)
    t1_last = torch.empty((N, bs.S), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("viterbi_banded", _SIGNATURES)
    P = cuda_lib.ptr
    producers, ring = k9_layout(bs.S, model)
    rc = lib.vspl_banded_forward_obs(
        P(logits), P(idx), P(prior), model, spw, *map(float, params), producers, ring,
        P(bv), P(cls),
        P(log_pi), P(lens_d), P(t1m1), P(t1_last), N, T, bs.S, bs.d_max, bv.shape[0],
        LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "banded forward with observations (K9)")
    banded_forward_obs.launches += 1
    return t1_last, t1m1


banded_forward.launches = 0
banded_backtrace.launches = 0
banded_forward_obs.launches = 0
