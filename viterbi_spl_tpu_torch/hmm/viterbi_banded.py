"""Exact banded fast path for the batched Viterbi decode (counterpart of
viterbi_spl_tpu/hmm/viterbi_banded.py): the host-side structure extraction
in NumPy, and kernels K1 (forward) and K2 (backtrace) — CUDA C++ in
csrc/viterbi_banded.cu, each with its plain PyTorch version here.

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

from .. import cuda_lib
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


def _profiles(bs: BandedStructure, device) -> tuple[torch.Tensor, torch.Tensor]:
    if bs.bv is None or not bs.classes:
        raise ValueError("banded structure carries no source-profile classes")
    bv = torch.as_tensor(np.ascontiguousarray(bs.bv[:, : bs.S]), device=device)
    cls = torch.as_tensor(bs.class_of_offset(), device=device)
    return bv, cls


def banded_forward_plain(bs: BandedStructure, log_pi, log_obs, lengths):
    """K1's plain version: log_obs [N, T, S] f32, log_pi [S], lengths [N].
    Returns (t1_last [N, S], t1m1 [N, T, S]); t1m1[:, t] = T1[t-1] (row 0
    zeros), and each track's carry freezes at its last frame."""
    N, T, S = log_obs.shape
    n, d_max = bs.n_bins, bs.d_max
    dev = log_obs.device
    bv, cls = _profiles(bs, dev)
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


def banded_backtrace_plain(bs: BandedStructure, t1m1, last_states, lengths):
    """K2's plain version: t1m1 [N, T, S], last_states [N], lengths [N] ->
    states [N, T] int32 (zeros at or beyond each track's length)."""
    N, T, S = t1m1.shape
    n, d_max = bs.n_bins, bs.d_max
    dev = t1m1.device
    bv, cls = _profiles(bs, dev)
    lengths = torch.as_tensor(lengths, device=dev)
    last = torch.as_tensor(last_states, device=dev).to(torch.int64)
    x = torch.arange(S, device=dev)
    uv_row = torch.where(x < n, bs.log_c_vu, bs.log_c_uu).to(torch.float32)
    states = torch.zeros((N, T), dtype=torch.int32, device=dev)
    s = last.clone()
    for t in range(T - 1, -1, -1):
        s = torch.where(t == lengths - 1, last, s)
        active = t < lengths
        states[:, t] = torch.where(active, s, 0).to(torch.int32)
        e = x[None, :] - s[:, None]  # [N, S] offset of source x from target s
        in_band = (e.abs() <= d_max) & (x[None, :] < n)
        c = cls[(e + d_max).clamp(0, 2 * d_max)]
        row = torch.where(in_band, bv[c, x[None, :]], LOG_TINY)
        row = torch.where(x[None, :] == n, bs.log_c_uv, row)
        row = torch.where((s == n)[:, None], uv_row[None, :], row)
        bp = first_argmax(t1m1[:, t] + row, dim=1)
        s = torch.where(active, bp, s)
    return states


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
    "vspl_banded_backtrace": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _F, _F, _F, _P],
}


def banded_forward(bs: BandedStructure, log_pi, log_obs: torch.Tensor, lengths):
    """K1: banded batched forward DP. Same contract as banded_forward_plain;
    on the GPU, rows of t1m1 at or beyond a track's length are left
    unwritten (the backtrace never reads them)."""
    N, T, S = log_obs.shape
    if S != bs.S:
        raise ValueError(f"log_obs has {S} states, the structure {bs.S}")
    lens = cuda_lib.host_lengths(lengths, N, T)
    if log_obs.device.type == "cpu":
        return banded_forward_plain(bs, torch.as_tensor(log_pi), log_obs, lens)
    dev = cuda_lib.cuda_operand(log_obs, "log_obs").device
    bv, cls = _profiles(bs, dev)
    log_pi = torch.as_tensor(log_pi, dtype=torch.float32).to(dev).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    t1m1 = torch.empty_like(log_obs)
    t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("viterbi_banded", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_banded_forward(
        P(log_obs), P(bv), P(cls), P(log_pi), P(lens_d), P(t1m1), P(t1_last),
        N, T, S, bs.d_max, bv.shape[0], LOG_TINY, bs.log_c_uv, bs.log_c_vu,
        bs.log_c_uu, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "banded forward (K1)")
    banded_forward.launches += 1
    return t1_last, t1m1


def banded_backtrace(bs: BandedStructure, t1m1: torch.Tensor, last_states, lengths):
    """K2: banded batched reverse chase. Returns states [N, T] int32;
    entries at or beyond each track's length are unspecified."""
    N, T, S = t1m1.shape
    if S != bs.S:
        raise ValueError(f"t1m1 has {S} states, the structure {bs.S}")
    lens = cuda_lib.host_lengths(lengths, N, T)
    if t1m1.device.type == "cpu":
        return banded_backtrace_plain(bs, t1m1, last_states, lens)
    dev = cuda_lib.cuda_operand(t1m1, "t1m1").device
    bv, cls = _profiles(bs, dev)
    last = torch.as_tensor(last_states).to(dev, torch.int32).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    states = torch.empty((N, T), dtype=torch.int32, device=dev)
    lib = cuda_lib.load("viterbi_banded", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_banded_backtrace(
        P(t1m1), P(bv), P(cls), P(last), P(lens_d), P(states), N, T, S,
        bs.d_max, bv.shape[0], LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "banded backtrace (K2)")
    banded_backtrace.launches += 1
    return states


banded_forward.launches = 0
banded_backtrace.launches = 0
