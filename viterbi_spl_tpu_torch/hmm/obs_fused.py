"""Fused observation models (counterpart of viterbi_spl_tpu/hmm/obs_pallas.py):
raw logits in, decoder-ready LOG observations out, in one pass over the
logits. K5 (shaun) and K6 (softmax, scaled or unscaled) are CUDA C++ in
csrc/obs.cu (tiles of whole frames bulk-copied into a shared-memory ring,
one warp per frame), on the per-frame code of csrc/obs_common.cuh that K9
(the banded forward with the observations inside) shares; each has its
plain PyTorch version here.

Layout: logits [N, T, n_bins] f32 -> log observations [N, T, S] f32, the
voiced bins at [0, n_bins) and the unvoiced state at n_bins — the input of
`banded_forward` / `dense_forward` as they stand. The TPU kernels' lane
padding to P, the host-side reflect staging and N % 8 are layout artefacts:
the kernels read the reflect padding through `reflect_index`, np.pad's own
index map.

Semantics: those of `shaun_log_obs_block` / `softmax_log_obs_block`
(obs_pallas.py:90-200), DIRECT in the log domain — peak lanes get
(x - gmax) + log c floored at log TINY, non-peak lanes exactly log TINY,
and a frame with no peak keeps NEG_PAD as its "no peak" maximum. They equal
log(hmm.obs.*_observation_probs + TINY) under the JAX package's tolerance
contract (obs_pallas.py:12-27): identical peak masks and exact log-TINY
lanes, about 2e-4 relative away from the floor, at most log 2 inside it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_lib, tracing
from .obs import find_peaks
from .viterbi import NEG_PAD, TINY

# log(TINY) as the exact numpy-f32 value, the floor every non-peak lane
# carries (bit-equal to np.log(np.float32(0) + TINY))
LOG_TINY_F32 = float(np.log(np.float32(TINY)))

# model ids of csrc/obs_common.cuh
SHAUN, SOFTMAX = 1, 2


@functools.lru_cache(maxsize=64)
def reflect_index(n_bins: int, spw: int) -> np.ndarray:
    """[n_bins + 2 spw] int32 (one array per argument pair, not to be
    written): the logit each reflect-padded position reads,
    np.pad(arange(n_bins), spw, mode="reflect") (the edge bin is not
    repeated; evaluate.py:199-203 of the JAX package stages the same)."""
    if not 1 <= spw < n_bins:
        raise ValueError(f"spw must be in [1, n_bins={n_bins}), got {spw}")
    return np.pad(np.arange(n_bins), spw, mode="reflect").astype(np.int32)


def shaun_params(threshold, p: float = 0.8, scale: float = 2.0) -> np.ndarray:
    """[3] f32: threshold, offset = log(p / (1 - p)) computed in float32,
    scale (obs_pallas.py:354-363)."""
    p32 = np.float32(p)
    offset = np.log(p32 / (np.float32(1.0) - p32))
    return np.asarray([np.float32(threshold), offset, np.float32(scale)], np.float32)


def softmax_params(threshold_logit, init_probs, n_bins: int, scaled: bool):
    """(vth, prior_uv) as [2] f32 and the voiced log-prior row [n_bins] f32,
    np.log(init_probs[:n_bins]) when scaled, all zeros (and prior_uv 1)
    when not (obs_pallas.py:283-294)."""
    log_prior = np.zeros(n_bins, np.float32)
    prior_uv = 1.0
    if scaled:
        pri = np.asarray(init_probs, np.float32)
        if pri.shape != (n_bins + 1,):
            raise ValueError(f"init_probs must be [{n_bins + 1}], got {pri.shape}")
        log_prior = np.log(pri[:n_bins])
        prior_uv = float(pri[n_bins])
    return np.asarray([np.float32(threshold_logit), prior_uv], np.float32), log_prior


def obs_params(obs: dict, n_bins: int) -> tuple[int, int, np.ndarray, np.ndarray]:
    """The JAX package's obs dict — dict(method="shaun", spw, threshold_logit,
    p=0.8, scale=2.0) or dict(method="softmax-scaled"/"softmax-unscaled",
    spw, threshold_logit, init_probs) — as (model id, spw, params [3] f32,
    log-prior row [n_bins] f32)."""
    method, spw = obs["method"], int(obs["spw"])
    if method == "shaun":
        params = shaun_params(obs["threshold_logit"], obs.get("p", 0.8), obs.get("scale", 2.0))
        return SHAUN, spw, params, np.zeros(n_bins, np.float32)
    if method in ("softmax-scaled", "softmax-unscaled"):
        p2, log_prior = softmax_params(
            obs["threshold_logit"], obs.get("init_probs"), n_bins, method == "softmax-scaled"
        )
        return SOFTMAX, spw, np.append(p2, np.float32(0.0)), log_prior
    raise ValueError(f"unknown obs method {method}")


# ----------------------------------------------------------------------
# Plain PyTorch versions of K5 and K6: shaun_log_obs_block and
# softmax_log_obs_block op for op, over [N, T, n_bins] on any device.
# ----------------------------------------------------------------------


def _peaks(x: torch.Tensor, spw: int) -> torch.Tensor:
    """Peak mask of [..., n_bins]: > the max of the spw bins to the left, >=
    the max of the spw to the right, reflect-padded."""
    reflect_index(x.shape[-1], spw)  # validates spw
    return find_peaks(x.reshape(-1, x.shape[-1]), spw).reshape(x.shape)


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)


def shaun_log_obs_plain(x: torch.Tensor, spw: int, params: np.ndarray) -> torch.Tensor:
    """K5's plain version: logits [..., n_bins] f32 and shaun_params ->
    log observations [..., S]."""
    dev = x.device
    th, offset, scale = (_f32(v, dev) for v in params[:3])
    is_peak = _peaks(x, spw)
    gmax = torch.where(is_peak, x, float(NEG_PAD)).amax(dim=-1, keepdim=True)
    any_peak = gmax > _f32(NEG_PAD, dev) / 2
    sign = torch.where(gmax >= th, 1.0, -1.0)
    s = scale * (gmax - th) + sign * offset
    p_voiced = torch.where(any_peak, torch.sigmoid(s), 0.0)
    d = x - gmax
    exps = torch.where(is_peak, torch.exp(d), 0.0)
    denom = exps.sum(dim=-1, keepdim=True)
    log_c = torch.log(p_voiced + float(TINY)) - torch.log(torch.clamp(denom, min=1e-30))
    log_tiny = _f32(LOG_TINY_F32, dev)
    probs_log = torch.where(is_peak, torch.maximum(d + log_c, log_tiny), log_tiny)
    uv = torch.log(1.0 - p_voiced + float(TINY))
    return torch.cat([probs_log, uv], dim=-1)


def softmax_log_obs_plain(x: torch.Tensor, spw: int, params: np.ndarray, log_prior) -> torch.Tensor:
    """K6's plain version: logits [..., n_bins] f32 and softmax_params ->
    log observations [..., S]."""
    dev = x.device
    vth, prior_uv = _f32(params[0], dev), _f32(params[1], dev)
    log_prior = torch.as_tensor(np.asarray(log_prior, np.float32), device=dev)
    is_peak = _peaks(x, spw)
    pmax = torch.where(is_peak, x, float(NEG_PAD)).amax(dim=-1, keepdim=True)
    any_peak = pmax > _f32(NEG_PAD, dev) / 2
    gmax = torch.maximum(pmax, vth)  # the non-melody logit is always in the set
    d = x - gmax
    exps = torch.where(is_peak, torch.exp(d), 0.0)
    exp_nm = torch.exp(vth - gmax)
    denom = exps.sum(dim=-1, keepdim=True) + exp_nm
    log_denom = torch.log(denom)
    log_tiny = _f32(LOG_TINY_F32, dev)
    voiced_log = torch.maximum(d - log_denom - log_prior, log_tiny)
    probs_log = torch.where(is_peak & any_peak, voiced_log, log_tiny)
    unvoiced = torch.where(any_peak, (exp_nm / denom) / prior_uv, 1.0 / prior_uv)
    return torch.cat([probs_log, torch.log(unvoiced + float(TINY))], dim=-1)


# ----------------------------------------------------------------------
# Kernel wrappers: the plain version for a CPU tensor, the CUDA kernel for
# a CUDA tensor (or an error); `launches` counts the kernel launches.
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vspl_shaun_log_obs": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P],
    "vspl_softmax_log_obs": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
}

# K5/K6's layout (csrc/obs.cu): a persistent grid of `blocks` blocks an SM,
# each one producer warp and `consumers` consumer warps over a ring of
# `stages` tiles of OBS_TILE_FRAMES frames in shared memory.
OBS_TILE_FRAMES = 8
OBS_CONSUMERS = (15, 7, 3, 1)
OBS_MAX_STAGES = 6
SMEM_PER_SM = 228 * 1024  # H100: 228 KB an SM, 1 KB of it reserved a block
SMEM_PER_BLOCK = 227 * 1024


def obs_smem_bytes(n_bins: int, spw: int, consumers: int, stages: int) -> int:
    """Dynamic shared memory of one K5/K6 block (csrc/obs.cu::vspl_obs_smem):
    full/empty mbarriers, the ring's stages (a tile plus alignment pad, in
    16-byte units), the index map, the log-prior row and each consumer's
    reflect-padded row."""
    n_stage = n_bins + 2 * spw
    stage_floats = (OBS_TILE_FRAMES * n_bins + 6) // 4 * 4
    return 16 * stages + 4 * (stages * stage_floats + n_stage + n_bins + consumers * n_stage)


@functools.lru_cache(maxsize=64)
def obs_layout(n_bins: int, spw: int) -> tuple[int, int, int]:
    """(blocks an SM, consumer warps a block, ring stages) of K5/K6: of one
    or two blocks an SM, each with a count of OBS_CONSUMERS consumer warps
    and two to OBS_MAX_STAGES stages that fit the SM's shared memory, the
    most consumer warps an SM, then the most stages, then two blocks
    (scripts/gpu_banded_probe.py --parts obsdesigns)."""
    reflect_index(n_bins, spw)  # validates spw
    fits = []
    for blocks in (1, 2):
        budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks - 1024)
        for consumers in OBS_CONSUMERS:
            stages = max((r for r in range(2, OBS_MAX_STAGES + 1)
                          if obs_smem_bytes(n_bins, spw, consumers, r) <= budget), default=0)
            if stages:
                fits.append((blocks * consumers, stages, blocks, consumers))
    if not fits:
        raise ValueError(f"no K5/K6 layout fits n_bins={n_bins}, spw={spw}")
    _, stages, blocks, consumers = max(fits)
    return blocks, consumers, stages


_TABLES: dict = {}


def device_table(table: np.ndarray, dev: torch.device, layer: str = "decode_service"
                 ) -> torch.Tensor:
    """A small host table (the reflect index map, a log-prior row) on the
    card, uploaded once (a `<layer>.wait` span): an upload from pageable
    memory waits for the stream, which would leave the card idle between
    back-to-back calls."""
    key = (str(dev), table.dtype.str, table.tobytes())
    if key not in _TABLES:
        if len(_TABLES) >= 64:
            _TABLES.clear()
        _TABLES[key] = tracing.upload(table, dev, layer)
    return _TABLES[key]


def _launch(logits: torch.Tensor, spw: int, params, log_prior=None, layout=None):
    """K5 (log_prior None) or K6 on a CUDA tensor. layout: (blocks an SM,
    consumer warps, stages), None for obs_layout's; a consumer's next frame
    may lie (OBS_TILE_FRAMES - 1 + consumers) // OBS_TILE_FRAMES tiles
    ahead, and the ring needs at least that many stages."""
    N, T, n_bins = logits.shape
    if n_bins > 1024 or N * T >= 2**31:
        raise ValueError(f"logits {tuple(logits.shape)}: n_bins <= 1024, N * T < 2^31")
    layout = layout or obs_layout(n_bins, spw)
    blocks, consumers, stages = layout
    if blocks < 1 or not 1 <= consumers <= max(OBS_CONSUMERS) or \
            stages < max(1, (OBS_TILE_FRAMES - 1 + consumers) // OBS_TILE_FRAMES):
        raise ValueError(f"K5/K6 takes 1-{max(OBS_CONSUMERS)} consumer warps and at least the "
                         f"stages a consumer's stride spans, not {layout}")
    dev = cuda_lib.cuda_operand(logits, "logits").device
    idx = device_table(reflect_index(n_bins, spw), dev)
    out = torch.empty((N, T, n_bins + 1), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("obs", _SIGNATURES)
    P = cuda_lib.ptr
    stream = cuda_lib.stream_ptr(dev)
    if log_prior is None:
        name = "vspl_shaun_log_obs"
        rc = lib.vspl_shaun_log_obs(P(logits), P(idx), P(out), N * T, n_bins, spw,
                                    *map(float, params[:3]), LOG_TINY_F32, *layout, stream)
    else:
        name = "vspl_softmax_log_obs"
        prior = device_table(np.asarray(log_prior, np.float32), dev)
        rc = lib.vspl_softmax_log_obs(P(logits), P(idx), P(prior), P(out), N * T, n_bins,
                                      spw, *map(float, params[:2]), LOG_TINY_F32, *layout, stream)
    cuda_lib.check(lib, rc, name)
    return out


def shaun_log_obs(logits: torch.Tensor, spw: int, params: np.ndarray) -> torch.Tensor:
    """K5: the shaun model, logits [N, T, n_bins] f32 and shaun_params ->
    [N, T, S] log observations."""
    if logits.device.type == "cpu":
        return shaun_log_obs_plain(logits, spw, params)
    out = _launch(logits, spw, params)
    shaun_log_obs.launches += 1
    return out


def softmax_log_obs(logits: torch.Tensor, spw: int, params: np.ndarray, log_prior) -> torch.Tensor:
    """K6: the softmax model (scaled or unscaled), logits [N, T, n_bins] f32
    and softmax_params -> [N, T, S] log observations."""
    if logits.device.type == "cpu":
        return softmax_log_obs_plain(logits, spw, params, log_prior)
    out = _launch(logits, spw, params, log_prior)
    softmax_log_obs.launches += 1
    return out


shaun_log_obs.launches = 0
softmax_log_obs.launches = 0


def _dispatch(logits: torch.Tensor, obs: dict, plain: bool) -> torch.Tensor:
    model, spw, params, log_prior = obs_params(obs, logits.shape[-1])
    x = logits.to(torch.float32)
    if model == SHAUN:
        return (shaun_log_obs_plain if plain else shaun_log_obs)(x, spw, params)
    return (softmax_log_obs_plain if plain else softmax_log_obs)(x, spw, params, log_prior)


def log_obs(logits: torch.Tensor, obs: dict) -> torch.Tensor:
    """K5 or K6, as the obs dict's method says (see obs_params)."""
    return _dispatch(logits, obs, plain=False)


def log_obs_plain(logits: torch.Tensor, obs: dict) -> torch.Tensor:
    """The plain version of the model an obs dict names, on any device."""
    return _dispatch(logits, obs, plain=True)


# ----------------------------------------------------------------------
# The observation tolerance contract, and logits that exercise it, shared
# by the tests and chip_smoke.py.
# ----------------------------------------------------------------------


def obs_contract(got: np.ndarray, want: np.ndarray, softmax: bool = False) -> dict:
    """Log observations `got` [..., S] against `want` (the plain version,
    or the JAX package's kernel) under the contract of obs_pallas.py:12-27:
    lanes at log TINY bit-equal; above -80 within 1e-6 + 2e-4 |want|; in
    the floor region at most 0.70 (log 2) apart and not below log TINY; the
    unvoiced lane within 1e-6 |want|, and for the softmax models (`softmax`)
    within 1e-6 |want| + (p + 1) 2^-24, p the frame's terms in the softmax
    denominator (its voiced lanes of `want` above log TINY, plus the
    non-melody term). A float32 sum of p positive terms in any order is
    within a relative (p - 1) 2^-24 of another order's, which is an absolute
    (p - 1) 2^-24 on its log; that is the contract's clause (a), reduction
    order in the peak-softmax denominator. Shaun's unvoiced lane,
    log(1 - p_v + TINY), has no sum. Returns each clause's verdict, "ok"
    when all hold, and the largest differences."""
    n_bins = want.shape[-1] - 1
    away, zero = want > -80.0, want <= LOG_TINY_F32 + 1e-3
    diff = np.abs(got - want)
    uv_tol = 1e-6 * np.abs(want[..., n_bins])
    if softmax:
        terms = (want[..., :n_bins] > LOG_TINY_F32 + 1e-3).sum(-1) + 1
        uv_tol = uv_tol + (terms + 1) * 2.0 ** -24
    res = {
        "log_tiny_lanes_equal": bool(np.array_equal(got[zero], want[zero])),
        "above_-80_within_rtol_2e-4": bool(np.all(diff[away] <= 1e-6 + 2e-4 * np.abs(want[away]))),
        "floor_within_0.70": bool(np.all(diff[~away] <= 0.70)
                                  and np.all(got[~away] >= LOG_TINY_F32 - 1e-4)),
        "unvoiced_within_rtol_1e-6" + ("_plus_sum_order" if softmax else ""):
            bool(np.all(diff[..., n_bins] <= uv_tol)),
    }
    res["ok"] = all(res.values())
    res["max_abs_err"] = float(diff.max())
    res["max_rel_err_above_-80"] = (
        float(np.max(diff[away] / np.maximum(np.abs(want[away]), 1e-30))) if away.any() else 0.0
    )
    res["exact_share"] = float(np.mean(got == want))
    return res


def contract_logits(rng: np.random.Generator, N: int, T: int, n_bins: int) -> np.ndarray:
    """[N, T, n_bins] f32 logits (N >= 2, T >= 6): noise, a tie-heavy track
    (integers 0..2), and frames with the peak at bin 0 (the reflect edge),
    at bin n_bins - 1, and with no peak at all (all equal)."""
    lg = rng.normal(-2, 1, (N, T, n_bins)).astype(np.float32)
    lg[0] = rng.integers(0, 3, (T, n_bins))
    ramp = np.arange(n_bins, dtype=np.float32) * np.float32(0.05)
    lg[1, 3], lg[1, 4], lg[1, 5] = -ramp, ramp - 4.0, 0.7
    return lg
