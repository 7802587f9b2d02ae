"""Measurements behind the banded kernels' design (K1, K9 and K2 of
viterbi_spl_tpu_torch/csrc/viterbi_banded.cu) on the GPU:

1. clocked observation frames: one block of w warps (w = 1, 4, 8), each
   computing whole frames of the shaun or softmax model with
   obs_common.cuh's vspl_obs_frame (the per-frame function of K5, K6 and
   K9's producers) on logits staged in shared memory; lane 0 of each warp
   reads clock64 and %globaltimer around every frame. Mean SM cycles and ns
   per frame per warp, at 361 states (spw 5) and 722 (spw 16).
   obsparts: the standalone K5/K6 of f0acbee (one warp a frame, the
   logits gathered from device memory through the index map), copied here
   with clock64 between the parts of every frame in every warp of the
   grid: staging, window maxima and peak test, exp and sums, stores. Mean
   SM cycles a frame per warp for each part, at the serving shapes (361
   states spw 5, 722 states spw 16 and 20), beside the shipped K5/K6.
   obsdesigns: the shipped K5/K6 (tiles of whole frames bulk-copied into a
   ring for consumer warps) at its rule's layout and at others, in turns
   with f0acbee's loop (the gather by plain loads, 64 warps an SM) and with
   a candidate in which each warp gathers its next frame by cp.async while
   it computes one (both appended below, on this tree's frame function),
   at the same shapes, every design bit-equal to the shipped one.
2. K9 at producer and ring layouts (P warps, R frames) other than its
   rule's, each launch bit-equal to K5/K6 -> K1 on the same logits, timed
   in turns with K1 alone (on K5/K6's output) and with the rule's layout:
   the CLI's batch shape (N=8, T=8000), bench.py's two serving shapes.
3. K2's two kernels apart: the backpointer pass and the chase, each timed
   alone at the headline shape (N=128, T=32768, 361 states) and at jdc 722
   (N=64, T=4096), on K1's t1m1 of uniform log observations, beside K2 by
   the route it takes there (k2_route); and variants
   of the pass, timed in turns with the shipped one (every variant that
   writes backpointers must give K2's states through the chase):
     ilp1, ilp2, ilp8  frames a thread takes at once (shipped: 4 at up to 32
                       band registers, 1 at 96)
     tile192           at most 192 targets a block (shipped: 384)
     loads_only        the rows' copy and the two row argmaxes, no in-band
                       candidates and no stores
4. K2's routes (banded_backtrace's route "pass" and "chain") in turns (pass,
   chain, chain, pass) over tracks x frames at 361 and 722 states, on K1's
   t1m1 of uniform log observations; the states of both routes must be
   equal. The data behind k2_takes_pass's constants.
5. K2's routes against the voiced share of the decoded paths (the chain
   skips its in-band scan at an unvoiced state): 128 tracks at 361 states
   and 32 at 722, 8192 frames, uniform log observations with the unvoiced
   lane raised by 30 in a random share of the frames; per share, the
   voiced share of the states and of the last states, and both routes'
   times in turns.

0. K1's frame, clocked (the k1_clocked variant: clock64 between the parts
   of a frame in every warp of track 0's block, and each warp's %warpid,
   whose value mod 4 is its SM sub-partition; the shipped frame and the
   earlier one with float warp maxima, k1_clocked_floats) at tonet 361
   (d_max 14, N=128)
   and jdc 722 (d_max 40, N=64), T=4096; and K1's ms against the number of
   tracks (one block per track) at both. --sass FILE writes the built
   library's SASS, whose frame loop gives the instructions each warp runs.

   k1layouts: K1 by one block per track and by clusters of 1, 2, 4 and 8
   blocks per track (banded_forward's `cluster`), and a candidate with four
   targets a thread (banded_quad_kernel, appended below), in turns, over
   tracks at 361 states (d_max 14 and 20) and 722, every layout bit-equal
   to one block per track; with the card's capacity in clusters and
   k1_cluster's choice.
   k1variants: the one-block frame's variants (K1_VARIANTS) in turns with
   the shipped frame at 361 states, 8 and 128 tracks.
   k1cluster: the cluster kernel's variants (K1_CLUSTER_VARIANTS) in turns
   with the shipped one at 722 states, 8 and 64 tracks.

    python3 scripts/gpu_banded_probe.py [--parts k1,k1layouts,k1variants,k1cluster,
                                                 obs,obsparts,obsdesigns,k9,k2,routes,
                                                 voicing] [--sass FILE]

Prints one JSON line per reading, and the card's name and power limit. Each
variant's source is csrc/viterbi_banded.cu, patched, with entries for the
clocked frames and for each of K2's kernels appended; it is built here with
nvcc and the port's flags. It is a measurement, not a decoder.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from viterbi_spl_tpu_torch import cuda_lib  # noqa: E402
from viterbi_spl_tpu_torch.hmm import obs_fused as OF  # noqa: E402
from viterbi_spl_tpu_torch.hmm import params as hmm_params  # noqa: E402
from viterbi_spl_tpu_torch.hmm import viterbi_banded as VB  # noqa: E402
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params  # noqa: E402

ILP = "  static constexpr int kIlp = kBand > VSPL_BAND_REGS ? 1 : 4;"
VARIANTS = {
    "shipped": [],
    "ilp1": [(ILP, "  static constexpr int kIlp = 1;")],
    "ilp2": [(ILP, "  static constexpr int kIlp = 2;")],
    "ilp8": [(ILP, "  static constexpr int kIlp = kBand > VSPL_BAND_REGS ? 4 : 8;")],
    "tile192": [("  static constexpr int kThreads = kBand > VSPL_BAND_REGS ? 256 : 384;",
                 "  static constexpr int kThreads = kBand > VSPL_BAND_REGS ? 256 : 192;")],
    "loads_only": [("  if (tid >= tile || s >= S) return;\n", "  return;\n")],
}
# Variants of the one-block K1 frame (banded_forward_kernel), each timed in
# turns with the shipped kernel and bit-equal to it:
#   store_cur  t1m1's row t from the thread's register (shipped: a shared
#              load of the previous row)
#   float_wmax 9cb2ea1's frame: the warps' maxima converted to floats after each
#              warp reduction and back to keys before the next (shipped: kept
#              as order keys)
#   reg_obs    observations loaded 4 frames ahead into registers (shipped: a
#              16-frame cp.async ring in shared memory)
#   chains2, chains8  the in-band candidates in 2 or 8 max chains (shipped: 4)
#   cheap_key  a two-operation order key for the voiced maximum
#   atomic     cheap_key's keys max-accumulated by each warp into one shared
#              slot a row (atomicMax), so a frame starts with one broadcast
#              load and no warp reduction
K1_STORE_CUR = [("      out[static_cast<size_t>(t) * S + tid] = prev[tid];\n",
                 "      out[static_cast<size_t>(t) * S + tid] = cur;\n")]
K1_KEY_WMAX = [
    ("  float wv = vspl_warp_max(tid < n ? cur : -CUDART_INF_F);\n"
     "  if (lane == 0) wmax[warp] = wv;\n",
     "  // each warp's voiced maximum, kept as its order key from one warp\n"
     "  // reduction to the next (no conversion between them on the frame's chain)\n"
     "  unsigned wv =\n"
     "      __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? cur : -CUDART_INF_F));\n"
     "  if (lane == 0) wmax[warp] = __uint_as_float(wv);\n"),
    ("    const float max_voiced =\n"
     "        vspl_warp_max(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)]);\n",
     "    const float max_voiced = vspl_key_value(__reduce_max_sync(\n"
     "        VSPL_FULL_MASK,\n"
     "        __float_as_uint(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)])));\n"),
    ("    wv = vspl_warp_max(tid < n ? nv : -CUDART_INF_F);\n"
     "    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = wv;\n",
     "    wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? nv : -CUDART_INF_F));\n"
     "    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = __uint_as_float(wv);\n"),
]


def on_keys(text):
    """`text` of 9cb2ea1's K1 frame as it reads with the warps' maxima kept as
    keys (the shipped frame): the anchors of the variants below."""
    for old, new in K1_KEY_WMAX:
        text = text.replace(old, new)
    return text


K1_REG_OBS = [
    ("  if constexpr (kObs == 0)\n"
     "    for (int r = 1; r <= VSPL_RING; ++r)\n"
     "      vspl_stage_one(obs_ring + (r % VSPL_RING) * S + tid,\n"
     "                     obs + static_cast<size_t>(min(r, len - 1)) * S + tid, real && r < len);\n",
     "  const float* obs_me = obs + min(tid, S - 1);\n"
     "  auto obs_at = [&](int f) {\n"
     "    return real ? __ldg(obs_me + static_cast<size_t>(min(f, len - 1)) * S) : 0.0f;\n"
     "  };\n"
     "  float o1 = obs_at(1), o2 = obs_at(2), o3 = obs_at(3), o4 = obs_at(4);\n"),
    ("      vspl_wait_oldest_row();  // this thread's observation of frame t\n"
     "      obs_t = real ? obs_ring[slot] : 0.0f;\n",
     "      obs_t = o1;\n      o1 = o2;\n      o2 = o3;\n      o3 = o4;\n      o4 = obs_at(t + 4);\n"),
    ("      vspl_stage_one(obs_ring + slot, obs + static_cast<size_t>(min(r, len - 1)) * S + tid,\n"
     "                     real && r < len);\n",
     "      (void)r;\n"),
]
# cheap_key: key_wmax with a two-operation key (sign-of-zero blind, which a
# maximum only added to nonzero constants never shows)
K1_MAX_KEY = ("// ---------------------------------------------------------------------------\n"
              "// K1 and K9\n",
              "// ---------------------------------------------------------------------------\n"
              "// K1 and K9\n"
              "__device__ __forceinline__ unsigned vspl_max_key(float v) {\n"
              "  const unsigned u = __float_as_uint(v);\n"
              "  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);\n"
              "}\n"
              "__device__ __forceinline__ float vspl_max_key_value(unsigned k) {\n"
              "  return __uint_as_float(k ^ (~static_cast<unsigned>(static_cast<int>(k) >> 31) |\n"
              "                              0x80000000u));\n"
              "}\n")
K1_CHEAP_KEY = [K1_MAX_KEY] + [(b, b.replace("vspl_order_key", "vspl_max_key")
                                .replace("vspl_key_value", "vspl_max_key_value"))
                               for _, b in K1_KEY_WMAX]
# atomic: the warps' maxima max-accumulated as keys into one of three shared
# slots (atomicMax by each warp's lane 0; the slot two rows back cleared by
# thread 0), so that a frame starts with one broadcast load and no warp
# reduction
K1_ATOMIC = [
    K1_MAX_KEY,
    ("  for (int i = tid; i < 2 * stride; i += blockDim.x) buf[i] = 0.0f;\n",
     "  for (int i = tid; i < 2 * stride; i += blockDim.x) buf[i] = 0.0f;\n"
     "  if (tid < 3) reinterpret_cast<unsigned*>(wmax)[tid] = 0u;\n"),
    ("  float wv = vspl_warp_max(tid < n ? cur : -CUDART_INF_F);\n"
     "  if (lane == 0) wmax[warp] = wv;\n",
     "  unsigned* wkey = reinterpret_cast<unsigned*>(wmax);\n"
     "  unsigned wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_max_key(tid < n ? cur : -CUDART_INF_F));\n"
     "  if (lane == 0) atomicMax(wkey, wv);\n"
     "  int k_rd = 0, k_wr = 1, k_free = 2;\n"),
    ("    const float max_voiced =\n"
     "        vspl_warp_max(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)]);\n",
     "    const float max_voiced = vspl_max_key_value(wkey[k_rd]);\n"
     "    if (tid == 0) wkey[k_free] = 0u;\n"),
    ("    wv = vspl_warp_max(tid < n ? nv : -CUDART_INF_F);\n"
     "    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = wv;\n",
     "    wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_max_key(tid < n ? nv : -CUDART_INF_F));\n"
     "    if (lane == 0) atomicMax(wkey + k_wr, wv);\n"
     "    {\n      const int k = k_rd;\n      k_rd = k_wr;\n      k_wr = k_free;\n      k_free = k;\n    }\n"),
]
LEAN_OLD = r"""  float wv = vspl_warp_max(tid < n ? cur : -CUDART_INF_F);
  if (lane == 0) wmax[warp] = wv;

  // in-band offsets whose source x = s + d is a voiced state
  const int d_lo = max(-d_max, -tid);
  const int d_hi = min(d_max, n - 1 - tid);
  // K1: each thread's observations stream through a VSPL_RING-frame ring in
  // shared memory, requested VSPL_RING frames ahead: a frame takes less
  // than a device-memory load
  if constexpr (kObs == 0)
    for (int r = 1; r <= VSPL_RING; ++r)
      vspl_stage_one(obs_ring + (r % VSPL_RING) * S + tid,
                     obs + static_cast<size_t>(min(r, len - 1)) * S + tid, real && r < len);
  int p = 0;
  for (int t = 1; t < len; ++t) {
    const int slot = (t % VSPL_RING) * S + tid;
    float obs_t = 0.0f;
    if constexpr (kObs == 0) {
      vspl_wait_oldest_row();  // this thread's observation of frame t
      obs_t = real ? obs_ring[slot] : 0.0f;
    }
    vspl_dp_sync<kObs>(dp_threads);
    if constexpr (kObs != 0) {
      // every DP thread has read frame t - 1: its slot goes back to the
      // producers; then frame t's slot
      if (tid == 0) vspl_mbar_arrive(vspl_smem_addr(&empty[k9_slot]));
      if (++k9_slot == R) {
        k9_slot = 0;
        k9_phase ^= 1;
      }
    }
    // K9: frame t's observation, waited for only when it is needed
    auto obs_now = [&]() {
      if constexpr (kObs != 0) {
        vspl_mbar_wait<false>(vspl_smem_addr(&full[k9_slot]), k9_phase);
        return obs_ring[k9_slot * S + tid];
      } else {
        return obs_t;
      }
    };
    const float* prev = buf + p * stride + d_max;
    // the voiced maximum of the previous row, from the warps' maxima
    const float max_voiced =
        vspl_warp_max(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)]);
    const float prev_uv = prev[n];
    float nv = -CUDART_INF_F;
    if (tid < n) {
      // the in-band candidates, then the seed (max is exact in any order)
      float acc;
      if constexpr (kRegBand) {
        const float* pv = prev + tid - d_max;  // pv[i] = T1[s + i - d_max]
        float a[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < VSPL_BAND_REGS; ++i) a[i % 4] = fmaxf(a[i % 4], pv[i] + band[i]);
        acc = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
      } else {
        acc = -CUDART_INF_F;
        for (int d = d_lo; d <= d_hi; ++d) {
          const int x = tid + d;
          acc = fmaxf(acc, prev[x] + prof[cls_s[d + d_max] * S + x]);
        }
      }
      acc = fmaxf(acc, fmaxf(max_voiced + log_tiny, prev_uv + log_c_uv));
      nv = acc + obs_now();
    } else if (tid == n) {
      nv = fmaxf(max_voiced + log_c_vu, prev_uv + log_c_uu) + obs_now();
    }
    if (real) {
      out[static_cast<size_t>(t) * S + tid] = prev[tid];
      buf[(1 - p) * stride + d_max + tid] = nv;
      cur = nv;
    }
    wv = vspl_warp_max(tid < n ? nv : -CUDART_INF_F);
    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = wv;
    p ^= 1;
    if constexpr (kObs == 0) {
      // refill the slot just used (its value is in nv) with frame t + VSPL_RING
      const int r = t + VSPL_RING;
      vspl_stage_one(obs_ring + slot, obs + static_cast<size_t>(min(r, len - 1)) * S + tid,
                     real && r < len);
    }
  }
"""
LEAN_NEW = r"""  // the warps' voiced maxima stay order keys from one warp reduction to the
  // next (no conversion on the frame's chain)
  unsigned wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? cur : -CUDART_INF_F));
  if (lane == 0) wmax[warp] = __uint_as_float(wv);

  // in-band offsets whose source x = s + d is a voiced state
  const int d_lo = max(-d_max, -tid);
  const int d_hi = min(d_max, n - 1 - tid);
  // K1: each thread's observations stream through a VSPL_RING-frame ring in
  // shared memory, requested VSPL_RING frames ahead: a frame takes less
  // than a device-memory load
  if constexpr (kObs == 0)
    for (int r = 1; r <= VSPL_RING; ++r)
      vspl_stage_one(obs_ring + (r % VSPL_RING) * S + tid,
                     obs + static_cast<size_t>(min(r, len - 1)) * S + tid, real && r < len);
  // addresses advanced a row a frame: the two carry rows and the two rows of
  // warp maxima (swapped), this thread's t1m1 entry, its ring slot and the
  // observation its refill brings (each used only when the thread's target
  // is real and the frame is in the track)
  float* prev = buf + d_max;
  float* next = buf + stride + d_max;
  float* wm_prev = wmax;
  float* wm_next = wmax + VSPL_MAX_WARPS;
  float* out_t = out + S + tid;
  int slot = (1 % VSPL_RING) * S + tid;
  const float* fill = obs + static_cast<size_t>(1 + VSPL_RING) * S + tid;
  for (int t = 1; t < len; ++t) {
    float obs_t = 0.0f;
    if constexpr (kObs == 0) {
      vspl_wait_oldest_row();  // this thread's observation of frame t
      obs_t = real ? obs_ring[slot] : 0.0f;
    }
    vspl_dp_sync<kObs>(dp_threads);
    if constexpr (kObs != 0) {
      // every DP thread has read frame t - 1: its slot goes back to the
      // producers; then frame t's slot
      if (tid == 0) vspl_mbar_arrive(vspl_smem_addr(&empty[k9_slot]));
      if (++k9_slot == R) {
        k9_slot = 0;
        k9_phase ^= 1;
      }
    }
    // K9: frame t's observation, waited for only when it is needed
    auto obs_now = [&]() {
      if constexpr (kObs != 0) {
        vspl_mbar_wait<false>(vspl_smem_addr(&full[k9_slot]), k9_phase);
        return obs_ring[k9_slot * S + tid];
      } else {
        return obs_t;
      }
    };
    // the voiced maximum of the previous row, from the warps' maxima
    const float max_voiced = vspl_key_value(__reduce_max_sync(
        VSPL_FULL_MASK, __float_as_uint(wm_prev[lane < nwarps ? lane : 0])));
    const float prev_uv = prev[n];
    float nv = -CUDART_INF_F;
    if (tid < n) {
      // the in-band candidates, then the seed (max is exact in any order)
      float acc;
      if constexpr (kRegBand) {
        const float* pv = prev + tid - d_max;  // pv[i] = T1[s + i - d_max]
        float a[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < VSPL_BAND_REGS; ++i) a[i % 4] = fmaxf(a[i % 4], pv[i] + band[i]);
        acc = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
      } else {
        acc = -CUDART_INF_F;
        for (int d = d_lo; d <= d_hi; ++d) {
          const int x = tid + d;
          acc = fmaxf(acc, prev[x] + prof[cls_s[d + d_max] * S + x]);
        }
      }
      acc = fmaxf(acc, fmaxf(max_voiced + log_tiny, prev_uv + log_c_uv));
      nv = acc + obs_now();
    } else if (tid == n) {
      nv = fmaxf(max_voiced + log_c_vu, prev_uv + log_c_uu) + obs_now();
    }
    if (real) {
      *out_t = prev[tid];
      next[tid] = nv;
      cur = nv;
    }
    out_t += S;
    wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? nv : -CUDART_INF_F));
    if (lane == 0) wm_next[warp] = __uint_as_float(wv);
    float* swap = prev;
    prev = next;
    next = swap;
    swap = wm_prev;
    wm_prev = wm_next;
    wm_next = swap;
    if constexpr (kObs == 0) {
      // refill the slot just used (its value is in nv) with frame t + VSPL_RING
      vspl_stage_one(obs_ring + slot, fill, real && t + VSPL_RING < len);
      fill += S;
      slot += S;
      if (slot >= VSPL_RING * S) slot -= VSPL_RING * S;
    }
  }
"""
# lean_loop: the frame's addresses advanced a row a frame (pointers swapped,
# the ring slot wrapped) instead of recomputed from t
K1_LEAN_LOOP = [(on_keys(LEAN_OLD), LEAN_NEW)]
# chains2, chains8: the in-band candidates in 2 or 8 independent max chains
# (shipped: 4)
CHAINS4 = """        float a[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < VSPL_BAND_REGS; ++i) a[i % 4] = fmaxf(a[i % 4], pv[i] + band[i]);
        acc = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
"""
CHAINS2 = """        float a[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < VSPL_BAND_REGS; ++i) a[i % 2] = fmaxf(a[i % 2], pv[i] + band[i]);
        acc = fmaxf(a[0], a[1]);
"""
CHAINS8 = """        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < VSPL_BAND_REGS; ++i) a[i % 8] = fmaxf(a[i % 8], pv[i] + band[i]);
        acc = fmaxf(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])),
                    fmaxf(fmaxf(a[4], a[5]), fmaxf(a[6], a[7])));
"""
K1_VARIANTS = {"store_cur": K1_STORE_CUR, "float_wmax": [(b, a) for a, b in K1_KEY_WMAX],
               "chains2": [(CHAINS4, CHAINS2)], "chains8": [(CHAINS4, CHAINS8)],
               "reg_obs": K1_REG_OBS, "cheap_key": K1_CHEAP_KEY,
               "atomic": [(on_keys(a), b) for a, b in K1_ATOMIC], "lean_loop": K1_LEAN_LOOP}

# K1 (banded_forward_kernel<*, 0>) with clock64 at the parts of a frame,
# per warp: the rest of the loop (the observation refill), the observation
# wait and the frame barrier, the voiced-max reduce, the candidate loop
# (through the observation add), the stores, and the warp max; means per
# frame of track 0 go to t1_last[0, 7 w + i] (i = 6: %warpid, whose value
# mod 4 is the warp's SM sub-partition). Its output is not a decode.
K1_PARTS = ("rest", "wait_barrier", "voiced_max", "candidates", "stores", "warp_max")
K1_CLOCKED = [
    ("  int p = 0;\n  for (int t = 1; t < len; ++t) {\n    const int slot = (t % VSPL_RING) * S + tid;\n",
     "  int p = 0;\n  long long acc_c[6] = {0, 0, 0, 0, 0, 0};\n  long long c_prev = clock64();\n"
     "  for (int t = 1; t < len; ++t) {\n    const long long c_top = clock64();\n"
     "    const int slot = (t % VSPL_RING) * S + tid;\n"),
    ("    vspl_dp_sync<kObs>(dp_threads);\n",
     "    vspl_dp_sync<kObs>(dp_threads);\n    const long long c0 = clock64();\n"),
    ("    const float prev_uv = prev[n];\n",
     "    const float prev_uv = prev[n];\n"
     "    asm volatile(\"\" ::\"f\"(max_voiced), \"f\"(prev_uv) : \"memory\");\n"
     "    const long long c1 = clock64();\n"),
    ("    if (real) {\n      out[static_cast<size_t>(t) * S + tid] = prev[tid];\n",
     "    asm volatile(\"\" ::\"f\"(nv) : \"memory\");\n    const long long c2 = clock64();\n"
     "    if (real) {\n      out[static_cast<size_t>(t) * S + tid] = prev[tid];\n"),
    ("      cur = nv;\n    }\n",
     "      cur = nv;\n    }\n    const long long c3 = clock64();\n"),
    ("    p ^= 1;\n",
     "    p ^= 1;\n    const long long c4 = clock64();\n"
     "    acc_c[0] += c_top - c_prev;\n    acc_c[1] += c0 - c_top;\n    acc_c[2] += c1 - c0;\n"
     "    acc_c[3] += c2 - c1;\n    acc_c[4] += c3 - c2;\n    acc_c[5] += c4 - c3;\n"
     "    c_prev = c4;\n"),
    ("  if (real) t1_last[static_cast<size_t>(track) * S + tid] = cur;\n}\n",
     "  if (real) t1_last[static_cast<size_t>(track) * S + tid] = cur;\n"
     "  if constexpr (kObs == 0) {\n    __syncthreads();\n"
     "    if (track == 0 && lane == 0 && len > 1) {\n      unsigned wid;\n"
     "      asm volatile(\"mov.u32 %0, %%warpid;\" : \"=r\"(wid));\n"
     "#pragma unroll\n      for (int i = 0; i < 6; ++i)\n"
     "        t1_last[7 * warp + i] = static_cast<float>(acc_c[i]) / (len - 1);\n"
     "      t1_last[7 * warp + 6] = static_cast<float>(wid);\n    }\n  }\n}\n"),
]
BANDED = cuda_lib.CSRC / "viterbi_banded.cu"

ENTRIES = r"""

__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One block: warp w computes frames w, w + warps, ... < frames; lane 0
// adds each frame's cycles and ns to out[2 w], out[2 w + 1].
template <int kModel>
__global__ void obs_clock_kernel(VsplObsArgs a, int frames, long long* out) {
  extern __shared__ float sm[];
  const int n_stage = a.n_bins + 2 * a.spw;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx_s = reinterpret_cast<int*>(sm);
  float* prior_s = sm + n_stage;
  float* stage = prior_s + a.n_bins + warp * (n_stage + a.n_bins + 1);
  float* obs = stage + n_stage;
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  for (int i = threadIdx.x; i < a.n_bins; i += blockDim.x) prior_s[i] = a.log_prior[i];
  __syncthreads();
  VsplObsArgs b = a;
  b.log_prior = prior_s;
  long long cyc = 0, ns = 0;
  for (int f = warp; f < frames; f += warps) {
    const float* row = a.logits + static_cast<size_t>(f) * a.n_bins;
    for (int j = lane; j < n_stage; j += 32) stage[j] = row[idx_s[j]];
    __syncwarp();
    const long long c0 = clock64();
    const unsigned long long t0 = probe_ns();
    vspl_obs_frame<kModel>(stage, obs, b, lane);
    __syncwarp();
    const unsigned long long t1 = probe_ns();
    const long long c1 = clock64();
    cyc += c1 - c0;
    ns += static_cast<long long>(t1 - t0);
  }
  if (lane == 0) {
    out[2 * warp] = cyc;
    out[2 * warp + 1] = ns;
  }
}

extern "C" int probe_obs_clock(const float* logits, const int* idx, const float* log_prior,
                               int model, int n_bins, int spw, float p0, float p1, float p2,
                               float log_tiny, int warps, int frames, long long* out) {
  const VsplObsArgs a{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  const int n_stage = n_bins + 2 * spw;
  const size_t smem = (n_stage + n_bins + warps * (n_stage + n_bins + 1)) * sizeof(float);
  auto kernel = model == VSPL_OBS_SHAUN ? obs_clock_kernel<VSPL_OBS_SHAUN>
                                        : obs_clock_kernel<VSPL_OBS_SOFTMAX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<1, 32 * warps, smem>>>(a, frames, out);
  return static_cast<int>(cudaGetLastError());
}

// K1 with four adjacent targets a thread, one block per track (a candidate
// design, timed against the shipped layouts): the carry row read as
// float4s (9 a frame at d_max <= 15, against 32 scalar loads for four
// targets), the four band columns in registers, a quarter of the warps in
// the frame barrier and the reductions.
template <int kHalo>
__global__ void __launch_bounds__(128, 1) banded_quad_kernel(
    const float* __restrict__ log_obs, const float* __restrict__ bv, const int* __restrict__ cls,
    const float* __restrict__ log_pi, const int* __restrict__ lengths, float* __restrict__ t1m1,
    float* __restrict__ t1_last, int T, int S, int d_max, float log_tiny, float log_c_uv,
    float log_c_vu, float log_c_uu) {
  constexpr int kQ = kHalo / 2 + 1;  // float4s a thread reads a frame
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  const int threads = blockDim.x;
  const int stride = 4 * threads + 2 * kHalo + 4;  // source x at x + kHalo
  float* buf = reinterpret_cast<float*>(smem_u64);  // [2][stride]
  float* wmax = buf + 2 * stride;                    // [2][32]
  float* ring = wmax + 2 * VSPL_MAX_WARPS;           // [VSPL_RING][4 threads]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = threads >> 5;
  const int track = blockIdx.x;
  const int n = S - 1;
  const int s0 = 4 * tid;
  for (int i = tid; i < 2 * stride; i += threads) buf[i] = 0.0f;
  float band[4][4 * kQ];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4 * kQ; ++e) {
      const int d = e - kHalo - j;
      if (d >= -(kHalo - 1) && d <= kHalo - 1) {
        const int sj = s0 + j, x = sj + d;
        band[j][e] = (d >= -d_max && d <= d_max && sj < n && x >= 0 && x < n)
                         ? bv[cls[d + d_max] * S + x] : -CUDART_INF_F;
      }
    }
  __syncthreads();
  const int len = lengths[track];
  const size_t base = static_cast<size_t>(track) * T * S;
  const float* obs = log_obs + base;
  float* out = t1m1 + base;
  float cur[4];
  float wv = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int sj = s0 + j;
    cur[j] = sj < S ? log_pi[sj] + obs[sj] : -CUDART_INF_F;
    if (sj < S) {
      buf[kHalo + sj] = cur[j];
      out[sj] = 0.0f;
    }
    if (sj < n) wv = fmaxf(wv, cur[j]);
  }
  wv = vspl_warp_max(wv);
  if (lane == 0) wmax[warp] = wv;
  auto stage = [&](int f) {
    if (f < len)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < S)
          vspl_copy_async(ring + (f % VSPL_RING) * 4 * threads + s0 + j,
                          obs + static_cast<size_t>(f) * S + s0 + j);
    vspl_commit_copies();
  };
  for (int f = 1; f <= VSPL_RING; ++f) stage(f);
  int p = 0;
  for (int t = 1; t < len; ++t) {
    vspl_wait_oldest_row();
    const float4 ob = *reinterpret_cast<const float4*>(ring + (t % VSPL_RING) * 4 * threads + s0);
    __syncthreads();
    const float* prev = buf + p * stride;
    const float max_voiced = vspl_warp_max(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)]);
    const float prev_uv = prev[kHalo + n];
    float acc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(prev + s0 + 4 * k);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * k + c, d = e - kHalo - j;
          if (d >= -(kHalo - 1) && d <= kHalo - 1)
            acc[j][e & 1] = fmaxf(acc[j][e & 1], vv[c] + band[j][e]);
        }
    }
    const float seed = fmaxf(max_voiced + log_tiny, prev_uv + log_c_uv);
    const float obv[4] = {ob.x, ob.y, ob.z, ob.w};
    float nv[4];
    wv = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sj = s0 + j;
      nv[j] = sj < n ? fmaxf(fmaxf(acc[j][0], acc[j][1]), seed) + obv[j]
            : sj == n ? fmaxf(max_voiced + log_c_vu, prev_uv + log_c_uu) + obv[j]
                      : -CUDART_INF_F;
      if (sj < S) out[static_cast<size_t>(t) * S + sj] = cur[j];
      if (sj < n) wv = fmaxf(wv, nv[j]);
      cur[j] = nv[j];
    }
    *reinterpret_cast<float4*>(buf + (1 - p) * stride + kHalo + s0) =
        make_float4(nv[0], nv[1], nv[2], nv[3]);
    wv = vspl_warp_max(wv);
    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = wv;
    p ^= 1;
    stage(t + VSPL_RING);
  }
  vspl_wait_all_rows();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (s0 + j < S) t1_last[static_cast<size_t>(track) * S + s0 + j] = cur[j];
}

extern "C" int probe_k1_quad(const float* log_obs, const float* bv, const int* cls,
                             const float* log_pi, const int* lengths, float* t1m1,
                             float* t1_last, int N, int T, int S, int d_max, float log_tiny,
                             float log_c_uv, float log_c_vu, float log_c_uu) {
  const int threads = ((S + 3) / 4 + 31) / 32 * 32;
  if (2 * d_max + 1 > 31 || threads > 128) return cudaErrorInvalidValue;
  const size_t smem = (2 * (4 * threads + 2 * 16 + 4) + 2 * VSPL_MAX_WARPS +
                       static_cast<size_t>(VSPL_RING) * 4 * threads) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(banded_quad_kernel<16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  banded_quad_kernel<16><<<N, threads, smem>>>(log_obs, bv, cls, log_pi, lengths, t1m1, t1_last,
                                                T, S, d_max, log_tiny, log_c_uv, log_c_vu,
                                                log_c_uu);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster kernel the card holds at once at (S,
// d_max, cluster), into *out (0 where no group of SMs holds one).
extern "C" int probe_cluster_capacity(int S, int d_max, int cluster, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const bool narrow = 2 * d_max + 1 <= VSPL_BAND_REGS;
  cudaError_t e = narrow ? banded_cluster_config<VSPL_BAND_REGS>(S, d_max, cluster, &cfg, attr)
                         : banded_cluster_config<VSPL_BAND_REGS_WIDE>(S, d_max, cluster, &cfg,
                                                                      attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(cluster * 1024);
  e = narrow ? cudaOccupancyMaxActiveClusters(out, banded_cluster_kernel<VSPL_BAND_REGS>, &cfg)
             : cudaOccupancyMaxActiveClusters(out, banded_cluster_kernel<VSPL_BAND_REGS_WIDE>,
                                              &cfg);
  return static_cast<int>(e);
}

// K2's pass alone (as vspl_banded_backtrace launches it).
extern "C" int probe_k2_pass(const float* t1m1, const float* bv, const int* cls,
                             const int* lengths, short* bp, int N, int T, int S, int d_max,
                             float log_tiny, float log_c_uv, float log_c_vu, float log_c_uu) {
  return static_cast<int>(launch_pass(t1m1, bv, cls, lengths, bp, N, T, S, (S + 7) / 8 * 8,
                                      d_max, log_tiny, log_c_uv, log_c_vu, log_c_uu, 0));
}

// K2's chase alone.
extern "C" int probe_k2_chase(const short* bp, const int* last, const int* lengths, int* states,
                              int N, int T, int S) {
  return static_cast<int>(
      vspl_launch_chase<short>(bp, last, lengths, states, N, T, (S + 7) / 8 * 8, 0));
}
"""

P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# f6e0's standalone K5/K6 (9cb2ea1 and f0acbee: one warp a frame, 8 warps a
# block, at most 16 blocks an SM, each lane gathering its frame's
# reflect-padded logits from device memory by the index map), copied into
# the probe with clock64 between the parts of every frame in every warp:
# staging (the gather, until its values are in shared memory), window
# maxima and the peak test (with the frame's peak maximum), exp and sums
# (up to log c / the denominator), stores. Each warp adds its cycles and
# frames to clk[0..4] (atomics, lane 0).
OBS_ENTRIES = r"""

#define PROBE_OBS_WARPS 8

template <int kModel>
__global__ void __launch_bounds__(PROBE_OBS_WARPS * 32)
    obs_parts_kernel(VsplObsArgs a, float* __restrict__ out, int n_frames,
                     unsigned long long* clk) {
  extern __shared__ float smem[];
  const int n_stage = a.n_bins + 2 * a.spw;
  const int S = a.n_bins + 1;
  int* idx_s = reinterpret_cast<int*>(smem);
  float* x_s = smem + n_stage + (threadIdx.x >> 5) * n_stage;
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_bins = a.n_bins, spw = a.spw;
  long long acc[4] = {0, 0, 0, 0};
  long long frames = 0;
  for (int f = blockIdx.x * PROBE_OBS_WARPS + (threadIdx.x >> 5); f < n_frames;
       f += gridDim.x * PROBE_OBS_WARPS) {
    const long long c0 = clock64();
    const float* row = a.logits + static_cast<size_t>(f) * n_bins;
    for (int j = lane; j < n_stage; j += 32) x_s[j] = row[idx_s[j]];
    __syncwarp();
    const long long c1 = clock64();
    unsigned peaks = 0;
    float pmax = VSPL_NEG_PAD;
    for (int k = 0, b = lane; b < n_bins; ++k, b += 32) {
      const float* w = x_s + b;
      const float x = w[spw];
      float left = w[0];
      float right = w[spw + 1];
      for (int i = 1; i < spw; ++i) {
        left = fmaxf(left, w[i]);
        right = fmaxf(right, w[spw + 1 + i]);
      }
      if (x > left && x >= right) {
        peaks |= 1u << k;
        pmax = fmaxf(pmax, x);
      }
    }
    pmax = vspl_warp_max(pmax);
    asm volatile("" : "+f"(pmax));
    const long long c2 = clock64();
    const bool any_peak = pmax > VSPL_NEG_PAD * 0.5f;
    float* o = out + static_cast<size_t>(f) * S;
    long long c3;
    if constexpr (kModel == VSPL_OBS_SHAUN) {
      const float th = a.p0, offset = a.p1, scale = a.p2;
      const float gmax = pmax;
      const float sign = gmax >= th ? 1.0f : -1.0f;
      const float s = __fadd_rn(__fmul_rn(scale, __fsub_rn(gmax, th)), __fmul_rn(sign, offset));
      const float p_voiced = any_peak ? 1.0f / (1.0f + expf(-s)) : 0.0f;
      float denom = 0.0f;
      for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
        if ((peaks >> k) & 1u) denom = __fadd_rn(denom, expf(__fsub_rn(x_s[spw + b], gmax)));
      denom = vspl_warp_sum(denom);
      float log_c =
          __fsub_rn(logf(__fadd_rn(p_voiced, FLT_MIN)), logf(fmaxf(denom, 1e-30f)));
      asm volatile("" : "+f"(log_c));
      c3 = clock64();
      for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
        o[b] = ((peaks >> k) & 1u)
                   ? fmaxf(__fadd_rn(__fsub_rn(x_s[spw + b], gmax), log_c), a.log_tiny)
                   : a.log_tiny;
      if (lane == 0) o[n_bins] = logf(__fadd_rn(__fsub_rn(1.0f, p_voiced), FLT_MIN));
    } else {
      const float vth = a.p0, prior_uv = a.p1;
      const float gmax = fmaxf(pmax, vth);
      float sum = 0.0f;
      for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
        if ((peaks >> k) & 1u) sum = __fadd_rn(sum, expf(__fsub_rn(x_s[spw + b], gmax)));
      sum = vspl_warp_sum(sum);
      const float exp_nm = expf(__fsub_rn(vth, gmax));
      const float denom = __fadd_rn(sum, exp_nm);
      float log_denom = logf(denom);
      asm volatile("" : "+f"(log_denom));
      c3 = clock64();
      for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
        o[b] = (((peaks >> k) & 1u) && any_peak)
                   ? fmaxf(__fsub_rn(__fsub_rn(__fsub_rn(x_s[spw + b], gmax), log_denom),
                                     a.log_prior[b]),
                           a.log_tiny)
                   : a.log_tiny;
      if (lane == 0) {
        const float unvoiced = any_peak ? (exp_nm / denom) / prior_uv : 1.0f / prior_uv;
        o[n_bins] = logf(__fadd_rn(unvoiced, FLT_MIN));
      }
    }
    __syncwarp();
    const long long c4 = clock64();
    acc[0] += c1 - c0;
    acc[1] += c2 - c1;
    acc[2] += c3 - c2;
    acc[3] += c4 - c3;
    ++frames;
  }
  if (lane == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(clk + i, static_cast<unsigned long long>(acc[i]));
    atomicAdd(clk + 4, static_cast<unsigned long long>(frames));
  }
}

extern "C" int probe_obs_parts(const float* logits, const int* idx, const float* log_prior,
                               float* out, int model, int n_frames, int n_bins, int spw,
                               float p0, float p1, float p2, float log_tiny,
                               unsigned long long* clk) {
  const VsplObsArgs a{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  const size_t smem =
      static_cast<size_t>(1 + PROBE_OBS_WARPS) * (n_bins + 2 * spw) * sizeof(float);
  auto kernel = model == VSPL_OBS_SHAUN ? obs_parts_kernel<VSPL_OBS_SHAUN>
                                        : obs_parts_kernel<VSPL_OBS_SOFTMAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (static_cast<long long>(n_frames) + PROBE_OBS_WARPS - 1) / PROBE_OBS_WARPS;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  kernel<<<blocks, PROBE_OBS_WARPS * 32, smem>>>(a, out, n_frames, clk);
  return static_cast<int>(cudaGetLastError());
}
"""
OBS_PARTS = ("staging", "window_maxima", "exp_and_sums", "stores")
# K5/K6 designs timed beside the shipped one (tiles of whole frames
# bulk-copied into a ring for consumer warps): f0acbee's loop (one warp a
# frame, 64 warps an SM, the gather by plain loads), and the rejected
# candidate in which each warp gathers its next frame by cp.async into a
# second row while it computes one (K9's producer loop); both on this
# tree's frame function.
OBS_CANDIDATES = r"""

// ---- f0acbee's K5/K6 loop (one warp a frame, the gather by plain loads) ----

#define PROBE_PR6_WARPS 8

template <int kModel>
__global__ void __launch_bounds__(PROBE_PR6_WARPS * 32)
    pr6_obs_kernel(VsplObsArgs a, float* __restrict__ out, int n_frames) {
  extern __shared__ float smem[];
  const int n_stage = a.n_bins + 2 * a.spw;
  const int S = a.n_bins + 1;
  int* idx_s = reinterpret_cast<int*>(smem);                     // [n_stage]
  float* stage = smem + n_stage + (threadIdx.x >> 5) * n_stage;  // this warp's frame
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int f = blockIdx.x * PROBE_PR6_WARPS + (threadIdx.x >> 5); f < n_frames;
       f += gridDim.x * PROBE_PR6_WARPS) {
    const float* row = a.logits + static_cast<size_t>(f) * a.n_bins;
    for (int j = lane; j < n_stage; j += 32) stage[j] = row[idx_s[j]];
    __syncwarp();
    vspl_obs_frame<kModel>(stage, out + static_cast<size_t>(f) * S, a, lane);
    __syncwarp();  // every lane has read the row before the next frame lands
  }
}

template <int kModel>
static int launch_pr6_obs(const VsplObsArgs& a, float* out, int n_frames, void* stream) {
  if (a.n_bins < 2 || a.n_bins > VSPL_OBS_MAX_BINS || a.spw < 1 || a.spw >= a.n_bins ||
      n_frames <= 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(1 + PROBE_PR6_WARPS) * (a.n_bins + 2 * a.spw) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pr6_obs_kernel<kModel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (static_cast<long long>(n_frames) + PROBE_PR6_WARPS - 1) / PROBE_PR6_WARPS;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  pr6_obs_kernel<kModel><<<blocks, PROBE_PR6_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, n_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_pr6_log_obs(const float* logits, const int* idx, const float* log_prior,
                                 float* out, int model, int n_frames, int n_bins, int spw,
                                 float p0, float p1, float p2, float log_tiny) {
  const VsplObsArgs a{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  return model == VSPL_OBS_SHAUN ? launch_pr6_obs<VSPL_OBS_SHAUN>(a, out, n_frames, nullptr)
                                 : launch_pr6_obs<VSPL_OBS_SOFTMAX>(a, out, n_frames, nullptr);
}


// ---- candidate: each warp gathers its next frame by cp.async while it computes one ----

#define PROBE_ASYNC_WARPS 8

// Dynamic shared memory of a block of `warps` warps: the index map, the
// log-prior row and two staged rows per warp.
inline size_t probe_async_smem(int n_bins, int spw, int warps) {
  const size_t n_stage = n_bins + 2 * spw;
  return (n_stage + n_bins + 2 * static_cast<size_t>(warps) * n_stage) * sizeof(float);
}

template <int kModel>
__global__ void __launch_bounds__(PROBE_ASYNC_WARPS * 32)
    async_obs_kernel(VsplObsArgs a, float* __restrict__ out, int n_frames) {
  extern __shared__ float smem[];
  const int n_bins = a.n_bins, n_stage = n_bins + 2 * a.spw, S = n_bins + 1;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx_s = reinterpret_cast<int*>(smem);                   // [n_stage]
  float* prior_s = smem + n_stage;                              // [n_bins]
  float* rows = prior_s + n_bins + 2 * warp * n_stage;          // this warp's [2][n_stage]
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  if (kModel == VSPL_OBS_SOFTMAX)
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) prior_s[i] = a.log_prior[i];
  __syncthreads();
  VsplObsArgs b = a;
  b.log_prior = prior_s;
  const int stride = gridDim.x * warps;
  int f = blockIdx.x * warps + warp;
  if (f < n_frames)
    vspl_stage_logits_async(rows, a.logits + static_cast<size_t>(f) * n_bins, idx_s, n_stage,
                            lane);
  for (int p = 0; f < n_frames; f += stride, p ^= 1) {
    const int fn = f + stride;
    if (fn < n_frames)
      vspl_stage_logits_async(rows + (1 - p) * n_stage, a.logits + static_cast<size_t>(fn) * n_bins,
                              idx_s, n_stage, lane);
    else
      vspl_commit_copies();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // frame f's logits
    __syncwarp();
    vspl_obs_frame<kModel>(rows + p * n_stage, out + static_cast<size_t>(f) * S, b, lane);
    __syncwarp();  // every lane has read row p before it is refilled
  }
  vspl_wait_all_rows();
}

template <int kModel>
static int launch_async_obs(const VsplObsArgs& a, float* out, int n_frames, int warps,
                          void* stream) {
  if (a.n_bins < 2 || a.n_bins > VSPL_OBS_MAX_BINS || a.spw < 1 || a.spw >= a.n_bins ||
      n_frames <= 0 || warps < 1 || warps > PROBE_ASYNC_WARPS)
    return cudaErrorInvalidValue;
  const size_t smem = probe_async_smem(a.n_bins, a.spw, warps);
  cudaError_t e = cudaFuncSetAttribute(
      async_obs_kernel<kModel>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, async_obs_kernel<kModel>, warps * 32,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (static_cast<long long>(n_frames) + warps - 1) / warps;
  const long long most = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(want < most ? want : most);
  async_obs_kernel<kModel><<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, n_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_async_log_obs(const float* logits, const int* idx, const float* log_prior,
                                   float* out, int model, int n_frames, int n_bins, int spw,
                                   float p0, float p1, float p2, float log_tiny, int warps) {
  const VsplObsArgs a{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  return model == VSPL_OBS_SHAUN
             ? launch_async_obs<VSPL_OBS_SHAUN>(a, out, n_frames, warps, nullptr)
             : launch_async_obs<VSPL_OBS_SOFTMAX>(a, out, n_frames, warps, nullptr);
}
"""


def patches(name):
    """The (old, new) source edits of a variant."""
    if name == "k1_clocked":
        return K1_CLOCKED
    if name == "k1_clocked_floats":
        return K1_VARIANTS["float_wmax"] + K1_CLOCKED
    for table in (K1_VARIANTS, K1_CLUSTER_VARIANTS, VARIANTS):
        if name in table:
            return table[name]
    raise KeyError(name)


def build(names) -> dict:
    """{variant: loaded library}, one nvcc per variant, all started together."""
    out_dir = cuda_lib.BUILD_DIR / "banded_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = BANDED.read_text()
    procs = {}
    for name in names:
        src = base
        for old, new in patches(name):
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the shipped source no longer has {old[:60]!r}")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src + ENTRIES)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        emit({"probe": "build", "variant": name,
              "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})
        lib = ctypes.CDLL(str(lib))
        lib.probe_obs_clock.argtypes = [P_, P_, P_, I_, I_, I_, F_, F_, F_, F_, I_, I_, P_]
        lib.probe_k2_pass.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_]
        lib.probe_k2_chase.argtypes = [P_, P_, P_, P_, I_, I_, I_]
        for fn, argtypes in VB._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
        lib.probe_k1_quad.argtypes = [P_, P_, P_, P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_]
        lib.probe_cluster_capacity.argtypes = [I_, I_, I_, P_]
        libs[name] = lib
    return libs


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))


def shaped(n_bins, d_max, seed):
    rng = np.random.default_rng(seed)
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 5000)), 0, n_bins - 1)]
    stats = hmm_params.count_statistics(walk, n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]), n_bins, d_max, floor=2)
    return A, hmm_params.shape_init_probs(stats.p_steady, p_th=1e-4)


def obs_cfg(method, spw, n_bins, seed):
    pri = np.random.default_rng(seed).random(n_bins + 1).astype(np.float32) + 0.1
    return dict(method=method, spw=spw, threshold_logit=0.0, init_probs=pri / pri.sum())


def clocked_frames(lib, dev):
    P = cuda_lib.ptr
    frames = 256
    for n_bins, spw in ((360, 5), (721, 16)):
        g = torch.Generator(device=dev).manual_seed(n_bins)
        logits = torch.randn((frames, n_bins), generator=g, device=dev).sub_(2.0)
        idx = torch.as_tensor(OF.reflect_index(n_bins, spw), device=dev)
        for method in ("shaun", "softmax-scaled"):
            model, _, params, log_prior = OF.obs_params(obs_cfg(method, spw, n_bins, 1), n_bins)
            prior = torch.as_tensor(log_prior, device=dev)
            for warps in (1, 4, 8):
                out = torch.zeros(2 * warps, dtype=torch.int64, device=dev)
                for _ in range(2):  # the first run warms the caches
                    out.zero_()
                    rc = lib.probe_obs_clock(P(logits), P(idx), P(prior), model, n_bins, spw,
                                             *map(float, params[:3]), VB.LOG_TINY, warps,
                                             frames, P(out))
                    if rc != 0:
                        raise RuntimeError(f"probe_obs_clock: CUDA error {rc}")
                    torch.cuda.synchronize()
                o = out.view(warps, 2).cpu().numpy().astype(np.float64)
                emit({"probe": "obs_frame", "S": n_bins + 1, "spw": spw, "method": method,
                      "warps": warps, "frames_per_warp": frames / warps,
                      "cycles_per_frame": float(o[:, 0].sum() / frames),
                      "ns_per_frame": float(o[:, 1].sum() / frames)})


def build_obs_probe():
    """csrc/obs.cu with OBS_ENTRIES appended, built and loaded."""
    out_dir = cuda_lib.BUILD_DIR / "banded_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "obs_probe.cu"
    cu.write_text((cuda_lib.CSRC / "obs.cu").read_text() + OBS_ENTRIES + OBS_CANDIDATES)
    lib = out_dir / "libobs_probe.so"
    proc = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
                           "-o", str(lib), str(cu)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the observation probe:\n{proc.stdout}{proc.stderr}")
    emit({"probe": "build", "variant": "obs_probe",
          "ptxas": [ln.strip() for ln in proc.stdout.splitlines() + proc.stderr.splitlines()
                    if "registers" in ln or "spill" in ln]})
    lib = ctypes.CDLL(str(lib))
    lib.probe_obs_parts.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_, P_]
    lib.probe_pr6_log_obs.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_]
    lib.probe_async_log_obs.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_, I_]
    return lib


# bench.py's serving shapes (logits normal - 2): label, n_bins, spw, N, T
OBS_SHAPES = (("tonet 361 serving", 360, 5, 128, 8192), ("jdc 722 serving", 721, 16, 64, 4096),
              ("jdc 722 serving spw 20", 721, 20, 64, 4096))


def obs_parts(dev):
    """The standalone K5/K6 frame split by clock64 in every warp of the
    grid, at the serving shapes, beside the shipped K5/K6's ms."""
    lib = build_obs_probe()
    P = cuda_lib.ptr
    for label, n_bins, spw, N, T in OBS_SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        logits = torch.randn((N, T, n_bins), generator=g, device=dev).sub_(2.0)
        idx = torch.as_tensor(OF.reflect_index(n_bins, spw), device=dev)
        for method in ("shaun", "softmax-scaled"):
            obs = obs_cfg(method, spw, n_bins, 2)
            model, _, params, log_prior = OF.obs_params(obs, n_bins)
            prior = torch.as_tensor(log_prior, device=dev)
            out = torch.empty((N, T, n_bins + 1), dtype=torch.float32, device=dev)
            clk = torch.zeros(5, dtype=torch.int64, device=dev)

            def run():
                rc = lib.probe_obs_parts(P(logits), P(idx), P(prior), P(out), model, N * T, n_bins,
                                         spw, *map(float, params[:3]), OF.LOG_TINY_F32, P(clk))
                if rc != 0:
                    raise RuntimeError(f"probe_obs_parts: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            if not torch.equal(out, OF.log_obs(logits, obs)):
                raise RuntimeError(f"{label} {method}: the clocked kernel differs from K5/K6")
            clk.zero_()
            ms_clocked = cuda_ms(run, 1)
            c = clk.cpu().numpy().astype(np.float64)
            emit({"probe": "obs_parts", "shape": label, "method": method, "N": N, "T": T,
                  "spw": spw, "sm_clock_mhz": sm_clock_mhz(),
                  "cycles_per_frame_per_warp": {k: float(v / c[4]) for k, v in zip(OBS_PARTS, c)},
                  "frames": int(c[4]), "clocked_ms": ms_clocked,
                  "shipped_ms": cuda_ms(lambda: OF.log_obs(logits, obs))})
            del out
        del logits
        torch.cuda.empty_cache()


def obs_designs(dev):
    """The shipped K5/K6 at its rule's layout and others (blocks an SM,
    consumer warps, stages) against f0acbee's loop and the async-gather
    candidate (8 and 4 warps a block), in turns (in order, then in
    reverse), at the serving shapes; every design bit-equal to the shipped
    one."""
    lib = build_obs_probe()
    P = cuda_lib.ptr
    for label, n_bins, spw, N, T in OBS_SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        logits = torch.randn((N, T, n_bins), generator=g, device=dev).sub_(2.0)
        idx = torch.as_tensor(OF.reflect_index(n_bins, spw), device=dev)
        rule = OF.obs_layout(n_bins, spw)
        for method in ("shaun", "softmax-scaled"):
            obs = obs_cfg(method, spw, n_bins, 2)
            model, _, params, log_prior = OF.obs_params(obs, n_bins)
            prior_arg = None if model == OF.SHAUN else log_prior
            prior = torch.as_tensor(log_prior, device=dev)
            out = torch.empty((N, T, n_bins + 1), dtype=torch.float32, device=dev)
            args = (P(logits), P(idx), P(prior), P(out), model, N * T, n_bins, spw,
                    *map(float, params[:3]), OF.LOG_TINY_F32)

            def c_entry(fn, *extra):
                def run():
                    rc = fn(*args, *extra)
                    if rc != 0:
                        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
                    return out
                return run

            designs = {f"shipped {rule}": lambda: OF._launch(logits, spw, params, prior_arg)}
            for lay in ((1, 15, 2), (2, 7, 2), (4, 7, 2)):
                designs[f"shipped {lay}"] = lambda lay=lay: OF._launch(logits, spw, params,
                                                                       prior_arg, layout=lay)
            designs["f0acbee loop"] = c_entry(lib.probe_pr6_log_obs)
            designs["async gather 8 warps"] = c_entry(lib.probe_async_log_obs, 8)
            designs["async gather 4 warps"] = c_entry(lib.probe_async_log_obs, 4)
            want = designs[f"shipped {rule}"]()
            for name, fn in designs.items():
                if not torch.equal(fn(), want):
                    raise RuntimeError(f"{label} {method}: {name} differs from the shipped K5/K6")
            del want
            ms = {k: [] for k in designs}
            for name in list(designs) + list(reversed(designs)):
                ms[name].append(cuda_ms(designs[name]))
            emit({"probe": "obs_designs", "shape": label, "method": method, "N": N, "T": T,
                  "spw": spw, "ms": {k: float(np.mean(v)) for k, v in ms.items()},
                  "readings_ms": ms})
            del out
        del logits
        torch.cuda.empty_cache()


def k1_frames(libs, dev, sass=None):
    """K1's frame split (the k1_clocked variant, track 0 of the launch) at
    tonet 361 (d_max 14) and jdc 722 (d_max 40), then K1's ms against the
    number of tracks at each (one block per track: up to 132 tracks are one
    wave, more share SMs)."""
    P = cuda_lib.ptr
    for label, n_bins, d_max, N, T, Ns in (("tonet 361", 360, 14, 128, 4096, (8, 64, 128, 256, 512)),
                                          ("jdc 722", 721, 40, 64, 4096, (8, 64, 128, 256))):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        log_pi = torch.as_tensor(log_pi, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        log_obs = torch.rand((max(Ns), T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
        bv, cls = VB.banded_profiles(bs, dev)
        lens = torch.full((N,), T, dtype=torch.int32, device=dev)
        obs = log_obs[:N].contiguous()
        t1m1 = torch.empty_like(obs)
        t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
        for frame, lib in (("shipped", libs["k1_clocked"]),
                           ("float maxima", libs["k1_clocked_floats"])):
            for _ in range(2):  # the first launch warms the caches
                rc = lib.vspl_banded_forward(P(obs), P(bv), P(cls), P(log_pi), P(lens), P(t1m1),
                                             P(t1_last), N, T, S, d_max, bv.shape[0],
                                             VB.LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu,
                                             None)
                if rc != 0:
                    raise RuntimeError(f"K1 clocked: CUDA error {rc}")
                torch.cuda.synchronize()
            warps = -(-S // 32)
            c = t1_last[0, : 7 * warps].view(warps, 7).cpu().numpy().astype(np.float64)
            sub = (c[:, 6].astype(int) % 4).tolist()
            emit({"probe": "k1_frame", "frame": frame, "shape": label, "N": N, "T": T, "S": S,
                  "d_max": d_max, "warps": warps, "sm_clock_mhz": sm_clock_mhz(),
                  "cycles_per_frame_mean": {k: float(c[:, i].mean())
                                            for i, k in enumerate(K1_PARTS)},
                  "cycles_per_frame_max": {k: float(c[:, i].max())
                                           for i, k in enumerate(K1_PARTS)},
                  "frame_cycles_mean": float(c[:, :6].sum(axis=1).mean()),
                  "warp_subpartition": sub,
                  "warps_per_subpartition": [sub.count(q) for q in range(4)]})
        del t1m1, obs
        for n_tr in Ns:
            o = log_obs[:n_tr].contiguous()
            lengths = np.full(n_tr, T, np.int32)
            ms = cuda_ms(lambda: VB.banded_forward(bs, log_pi, o, lengths))
            emit({"probe": "k1_tracks", "shape": label, "N": n_tr, "T": T, "S": S, "ms": ms,
                  "us_per_frame": 1e3 * ms / T})
            del o
            torch.cuda.empty_cache()
        del log_obs
        torch.cuda.empty_cache()
    if sass:
        so = next((cuda_lib.BUILD_DIR).glob("libviterbi_banded-*.so"))
        Path(sass).parent.mkdir(parents=True, exist_ok=True)
        Path(sass).write_text(subprocess.run(
            [str(Path(cuda_lib.nvcc_path()).parent / "cuobjdump"), "-sass", str(so)],
            capture_output=True, text=True, check=True).stdout)


K1_GRID = (("tonet 361", 360, 14, (8, 64, 128, 256), (0, 1, 2, 4, 8)),
           ("361 states, d_max 20", 360, 20, (8, 64, 128), (0, 2, 4, 8)),
           ("jdc 722", 721, 40, (8, 64, 128), (0, 2, 4, 8)))


def k1_layouts(dev, quad, T=4096):
    """K1 by one block per track (cluster 0) and by clusters of C blocks per
    track, in turns (each in order, then in reverse), at 361 and 722 states
    over tracks; every layout bit-equal to cluster 0. With the card's
    capacity for each cluster size and k1_cluster's choice."""
    P = cuda_lib.ptr
    for label, n_bins, d_max, Ns, layouts in K1_GRID:
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        cap = {}
        for C in layouts[1:]:
            out = ctypes.c_int(0)
            rc = quad.probe_cluster_capacity(S, d_max, C, ctypes.byref(out))
            cap[C] = out.value if rc == 0 else f"error {rc}"
        g = torch.Generator(device=dev).manual_seed(3)
        log_obs = torch.rand((max(Ns), T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
        for N in Ns:
            o = log_obs[:N].contiguous()
            lengths = np.full(N, T, np.int32)
            run = {C: (lambda C=C: VB.banded_forward(bs, log_pi, o, lengths, cluster=C))
                   for C in layouts}
            if 2 * d_max + 1 <= 31:
                bv, cls = VB.banded_profiles(bs, dev)
                lpi = torch.as_tensor(log_pi, device=dev)
                lens = torch.as_tensor(lengths, device=dev)

                def run_quad():
                    t1m1 = torch.empty_like(o)
                    t1 = torch.empty((N, S), dtype=torch.float32, device=dev)
                    rc = quad.probe_k1_quad(P(o), P(bv), P(cls), P(lpi), P(lens), P(t1m1), P(t1),
                                            N, T, S, d_max, VB.LOG_TINY, bs.log_c_uv,
                                            bs.log_c_vu, bs.log_c_uu)
                    if rc != 0:
                        raise RuntimeError(f"probe_k1_quad: CUDA error {rc}")
                    return t1, t1m1
                run["quad"] = run_quad
            want = run[0]()
            for C in list(run)[1:]:
                got = run[C]()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"K1 cluster {C} differs from one block a track ({label})")
                del got
            del want
            ms = {C: [] for C in run}
            for C in list(run) + list(reversed(list(run))):
                ms[C].append(cuda_ms(run[C], iters=3))
            emit({"probe": "k1_layouts", "shape": label, "N": N, "T": T, "S": S,
                  "capacity_clusters": cap, "rule": VB.k1_cluster(N, S, d_max),
                  "ms": {C: float(np.mean(v)) for C, v in ms.items()}, "readings_ms": ms,
                  "us_per_frame": {C: 1e3 * float(np.mean(v)) / T for C, v in ms.items()}})
            del o
            torch.cuda.empty_cache()
        del log_obs
        torch.cuda.empty_cache()


def k1_variants(libs, dev, T=4096):
    """The one-block K1 frame's variants (K1_VARIANTS) in turns with the
    shipped kernel (each in order, then in reverse) at tonet 361 over 8 and
    128 tracks; each bit-equal to the shipped kernel."""
    P = cuda_lib.ptr
    A, pi = shaped(360, 14, 0)
    bs = VB.extract_banded_structure(A)
    S = 361
    _, log_pi = prepare_log_params(A, pi)
    lpi = torch.as_tensor(log_pi, device=dev)
    bv, cls = VB.banded_profiles(bs, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    log_obs = torch.rand((128, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
    names = ["shipped"] + list(K1_VARIANTS)
    for N in (8, 128):
        o = log_obs[:N].contiguous()
        lens = torch.full((N,), T, dtype=torch.int32, device=dev)
        lens[1] = T // 2 + 1  # a ragged length among them

        def run(name):
            t1m1 = torch.empty_like(o)
            t1 = torch.empty((N, S), dtype=torch.float32, device=dev)
            rc = libs[name].vspl_banded_forward(P(o), P(bv), P(cls), P(lpi), P(lens), P(t1m1),
                                                P(t1), N, T, S, 14, bv.shape[0], VB.LOG_TINY,
                                                bs.log_c_uv, bs.log_c_vu, bs.log_c_uu, None)
            if rc != 0:
                raise RuntimeError(f"K1 variant {name}: CUDA error {rc}")
            return t1, t1m1

        want = run("shipped")
        for name in names[1:]:
            got = run(name)
            same = torch.equal(got[0], want[0]) and all(
                torch.equal(got[1][n, :L], want[1][n, :L]) for n, L in enumerate(lens.tolist()))
            if not same:
                raise RuntimeError(f"K1 variant {name} differs from the shipped kernel")
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            ms[name].append(cuda_ms(lambda: run(name), iters=5))
        emit({"probe": "k1_variants", "N": N, "T": T, "S": S,
              "ms": {n: float(np.mean(v)) for n, v in ms.items()}, "readings_ms": ms})
        del o
        torch.cuda.empty_cache()


# Variants of K1's cluster kernel (banded_cluster_kernel), timed in turns
# with the shipped one and bit-equal to it:
#   cluster_keys  the warps' maxima sent and reduced as order keys (shipped:
#                 as floats, converted around each warp reduction)
K1_CLUSTER_VARIANTS = {"cluster_keys": [
    ("    const float w = vspl_warp_max(real && s < n ? v : -CUDART_INF_F);\n"
     "    if (lane < C) vspl_store_remote(q ? wm1 : wm0, w, q ? wmb1 : wmb0);\n",
     "    const unsigned w =\n"
     "        __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(real && s < n ? v : -CUDART_INF_F));\n"
     "    if (lane < C) vspl_store_remote(q ? wm1 : wm0, __uint_as_float(w), q ? wmb1 : wmb0);\n"),
    ("    const float max_voiced = vspl_warp_max(wmax[b * VSPL_MAX_WARPS + (lane < n_wmax ? lane : 0)]);\n",
     "    const float max_voiced = vspl_key_value(__reduce_max_sync(\n"
     "        VSPL_FULL_MASK, __float_as_uint(wmax[b * VSPL_MAX_WARPS + (lane < n_wmax ? lane : 0)])));\n"),
]}


def k1_cluster_variants(libs, dev, T=4096):
    """K1's cluster kernel and its variants (K1_CLUSTER_VARIANTS) in turns at
    jdc 722 (d_max 40) over 8 tracks (8 blocks a track) and 64 (2 a
    track); each bit-equal to the shipped kernel."""
    P = cuda_lib.ptr
    A, pi = shaped(721, 40, 1)
    bs = VB.extract_banded_structure(A)
    S = 722
    _, log_pi = prepare_log_params(A, pi)
    lpi = torch.as_tensor(log_pi, device=dev)
    bv, cls = VB.banded_profiles(bs, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    log_obs = torch.rand((64, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
    names = ["shipped"] + list(K1_CLUSTER_VARIANTS)
    for N, C in ((8, 8), (64, 2)):
        o = log_obs[:N].contiguous()
        lens = torch.full((N,), T, dtype=torch.int32, device=dev)
        lens[1] = T // 2 + 1

        def run(name):
            t1m1 = torch.empty_like(o)
            t1 = torch.empty((N, S), dtype=torch.float32, device=dev)
            rc = libs[name].vspl_banded_forward_cluster(
                P(o), P(bv), P(cls), P(lpi), P(lens), P(t1m1), P(t1), N, T, S, 40, C,
                VB.LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu, None)
            if rc != 0:
                raise RuntimeError(f"K1 cluster variant {name}: CUDA error {rc}")
            return t1, t1m1

        want = run("shipped")
        for name in names[1:]:
            got = run(name)
            if not (torch.equal(got[0], want[0]) and all(
                    torch.equal(got[1][n, :L], want[1][n, :L]) for n, L in enumerate(lens.tolist()))):
                raise RuntimeError(f"K1 cluster variant {name} differs from the shipped kernel")
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            ms[name].append(cuda_ms(lambda: run(name), iters=5))
        emit({"probe": "k1_cluster_variants", "N": N, "C": C, "T": T, "S": S,
              "ms": {n: float(np.mean(v)) for n, v in ms.items()}, "readings_ms": ms})
        del o
        torch.cuda.empty_cache()


def sm_clock_mhz() -> str:
    """The SM clock nvidia-smi reads now (the card sets it itself)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def k9_layouts(dev):
    shapes = [("CLI batch 361", 360, 14, 5, 8, 8000, [(2, 32), (4, 32), (6, 32), (8, 32),
                                                      (12, 32), (16, 32), (8, 16), (8, 48)]),
              ("tonet 361 serving", 360, 14, 5, 128, 8192, [(4, 32), (6, 32), (8, 32),
                                                             (12, 32), (16, 32)]),
              ("jdc 722 serving", 721, 40, 16, 64, 4096, [(1, 16), (2, 16), (3, 16), (4, 16),
                                                          (6, 16), (9, 16), (4, 8), (4, 32)])]
    rule = VB.k9_layout
    for label, n_bins, d_max, spw, N, T, layouts in shapes:
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        _, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(7)
        logits = torch.randn((N, T, n_bins), generator=g, device=dev).sub_(2.0)
        lengths = np.full(N, T, np.int32)
        if N == 8:
            lengths = np.linspace(2000, 8000, 8).astype(np.int32)
        for method in ("shaun", "softmax-scaled"):
            obs = obs_cfg(method, spw, n_bins, 2)
            model = OF.obs_params(obs, n_bins)[0]
            log_obs = OF.log_obs(logits, obs)
            t1_ref, m_ref = VB.banded_forward(bs, log_pi, log_obs, lengths)
            k1 = lambda: VB.banded_forward(bs, log_pi, log_obs, lengths)  # noqa: E731
            k56_k1 = lambda: VB.banded_forward(bs, log_pi, OF.log_obs(logits, obs), lengths)  # noqa: E731
            rec = {"probe": "k9_layout", "shape": label, "N": N, "T": T, "S": n_bins + 1,
                   "method": method, "rule": list(rule(n_bins + 1, model)),
                   "K1_ms_before": cuda_ms(k1), "K5K6_K1_ms": cuda_ms(k56_k1), "layouts": {}}
            for lay in [rule(n_bins + 1, model)] + layouts:
                VB.k9_layout = lambda S, m, lay=lay: lay  # noqa: E731
                t1, m = VB.banded_forward_obs(bs, log_pi, logits, lengths, obs)
                exact = bool(torch.equal(t1, t1_ref)) and all(
                    torch.equal(m[i, :L], m_ref[i, :L]) for i, L in enumerate(lengths))
                del m
                ms = cuda_ms(lambda: VB.banded_forward_obs(bs, log_pi, logits, lengths, obs))
                rec["layouts"][f"P{lay[0]} R{lay[1]}"] = {"ms": ms, "exact": exact}
                if not exact:
                    raise RuntimeError(f"K9 at {lay} differs from K5/K6 -> K1 ({label}, {method})")
            VB.k9_layout = rule
            rec["K1_ms_after"] = cuda_ms(k1)
            emit(rec)
            del log_obs, m_ref
            torch.cuda.empty_cache()
        del logits
        torch.cuda.empty_cache()


def k2_split(libs, dev):
    P = cuda_lib.ptr
    lib = libs["shipped"]
    for label, n_bins, d_max, N, T in (("tonet 361", 360, 14, 128, 32768),
                                       ("jdc 722", 721, 40, 64, 4096)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(3)
        log_obs = torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
        lengths = np.full(N, T, np.int32)
        t1, t1m1 = VB.banded_forward(bs, log_pi, log_obs, lengths)
        del log_obs
        torch.cuda.empty_cache()
        last = torch.argmax(t1, dim=1).to(torch.int32)
        bv, cls = VB.banded_profiles(bs, dev)
        lens = torch.as_tensor(lengths, device=dev)
        bp = torch.empty((N, T, VB.bp_row_entries(S)), dtype=torch.int16, device=dev)
        states = torch.empty((N, T), dtype=torch.int32, device=dev)
        want = VB.banded_backtrace(bs, t1m1, last, lengths)

        def run_pass(lib):
            rc = lib.probe_k2_pass(P(t1m1), P(bv), P(cls), P(lens), P(bp), N, T, S, d_max,
                                   VB.LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu)
            if rc != 0:
                raise RuntimeError(f"probe_k2_pass: CUDA error {rc}")

        def run_chase(lib):
            rc = lib.probe_k2_chase(P(bp), P(last), P(lens), P(states), N, T, S)
            if rc != 0:
                raise RuntimeError(f"probe_k2_chase: CUDA error {rc}")

        run_pass(lib)
        ms_chase = cuda_ms(lambda: run_chase(lib))
        rec = {"probe": "k2_split", "shape": label, "N": N, "T": T, "S": S,
               "chase_ms": ms_chase, "chase_us_per_step": 1e3 * ms_chase / (T - 1),
               "K2_ms": cuda_ms(lambda: VB.banded_backtrace(bs, t1m1, last, lengths)),
               "K2_route": VB.k2_route(bs, N, T, last),
               "bp_scratch_bytes": bp.numel() * 2, "pass_ms": {}}
        for name, vlib in libs.items():
            if name not in VARIANTS or name == "shipped":
                continue
            shipped_a = cuda_ms(lambda: run_pass(lib))
            ms = cuda_ms(lambda: run_pass(vlib))
            shipped_b = cuda_ms(lambda: run_pass(lib))
            if name != "loads_only":
                run_chase(lib)
                if not torch.equal(states, want):
                    raise RuntimeError(f"pass variant {name} gives other states than K2 ({label})")
            rec["pass_ms"][name] = ms
            rec["pass_ms"].setdefault("shipped", []).extend([shipped_a, shipped_b])
        run_pass(lib)
        run_chase(lib)
        rec["states_equal"] = bool(torch.equal(states, want))
        emit(rec)
        if not rec["states_equal"]:
            raise RuntimeError("the probe's pass and chase disagree with K2")
        del t1m1, bp
        torch.cuda.empty_cache()


ROUTE_TRACKS = (1, 8, 16, 32, 64, 96, 128, 192, 256, 512, 1024)
ROUTE_FRAMES = (1024, 4096, 8192, 16384, 32768)
ROUTE_MAX_BYTES = 16e9  # t1m1 of one grid cell at most


def k2_routes(dev):
    for n_bins, d_max in ((360, 14), (721, 40)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        for T in ROUTE_FRAMES:
            Ns = [N for N in ROUTE_TRACKS if N * T * S * 4 <= ROUTE_MAX_BYTES]
            Nmax = Ns[-1]
            g = torch.Generator(device=dev).manual_seed(5)
            log_obs = torch.rand((Nmax, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
            t1_all, t1m1_all = VB.banded_forward(bs, log_pi, log_obs, np.full(Nmax, T, np.int32))
            del log_obs
            torch.cuda.empty_cache()
            last_all = torch.argmax(t1_all, dim=1).to(torch.int32)
            for N in Ns:
                t1m1, last, lengths = t1m1_all[:N], last_all[:N], np.full(N, T, np.int32)
                run = {r: (lambda r=r: VB.banded_backtrace(bs, t1m1, last, lengths, route=r))
                       for r in ("pass", "chain")}
                same = bool(torch.equal(run["pass"](), run["chain"]()))
                ms = {"pass": [], "chain": []}
                for r in ("pass", "chain", "chain", "pass"):
                    ms[r].append(cuda_ms(run[r], iters=3))
                rec = {"probe": "k2_routes", "S": S, "d_max": d_max, "N": N, "T": T,
                       "pass_ms": min(ms["pass"]), "chain_ms": min(ms["chain"]),
                       "pass_ps_per_item": 1e9 * min(ms["pass"]) / (N * S * (2 * d_max + 1) * T),
                       "chain_us_per_step": 1e3 * min(ms["chain"]) / T,
                       "rule_route": VB.k2_route(bs, N, T, last),
                       "bp_scratch_bytes": 2 * N * T * VB.bp_row_entries(S),
                       "states_equal": same}
                emit(rec)
                torch.cuda.empty_cache()
                if not same:
                    raise RuntimeError(f"K2's routes disagree at S={S} N={N} T={T}")
            del t1m1_all, t1_all
            torch.cuda.empty_cache()


def k2_voicing(dev):
    T = 8192
    for n_bins, d_max, N in ((360, 14, 128), (721, 40, 32)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        lengths = np.full(N, T, np.int32)
        for share in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0):
            g = torch.Generator(device=dev).manual_seed(7)
            log_obs = torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
            raise_uv = torch.rand((N, T), generator=g, device=dev) < share
            log_obs[:, :, n_bins] += 30.0 * raise_uv
            t1, t1m1 = VB.banded_forward(bs, log_pi, log_obs, lengths)
            del log_obs
            last = torch.argmax(t1, dim=1).to(torch.int32)
            run = {r: (lambda r=r: VB.banded_backtrace(bs, t1m1, last, lengths, route=r))
                   for r in ("pass", "chain")}
            states = run["chain"]()
            same = bool(torch.equal(run["pass"](), states))
            ms = {"pass": [], "chain": []}
            for r in ("pass", "chain", "chain", "pass"):
                ms[r].append(cuda_ms(run[r], iters=3))
            emit({"probe": "k2_voicing", "S": S, "d_max": d_max, "N": N, "T": T,
                  "uv_raised_share": share,
                  "voiced_share": float((states != n_bins).float().mean()),
                  "voiced_share_last": float((last != n_bins).float().mean()),
                  "pass_ms": min(ms["pass"]), "chain_ms": min(ms["chain"]),
                  "chain_us_per_step": 1e3 * min(ms["chain"]) / T,
                  "pass_us_per_frame": 1e3 * min(ms["pass"]) / T,
                  "rule_route": VB.k2_route(bs, N, T, last),
                  "states_equal": same})
            del t1m1, t1
            torch.cuda.empty_cache()
            if not same:
                raise RuntimeError(f"K2's routes disagree at S={S}, share {share}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="k1,k1layouts,k1variants,k1cluster,obs,obsparts,obsdesigns,k9,k2,"
                    "routes,voicing",
                    help="comma-separated: k1 (K1's clocked frame and ms by tracks), "
                         "k1layouts (K1 by one block and by clusters a track), k1variants "
                         "(the one-block frame's variants), k1cluster (the cluster kernel's), obs "
                         "(clocked observation frames), obsparts (the standalone K5/K6 frame's parts, "
                         "clocked), obsdesigns (K5/K6 designs in turns), k9 (layouts), k2 (split), routes (K2's "
                         "two routes), voicing (the routes by voiced share)")
    ap.add_argument("--sass", default=None,
                    help="with the k1 part: write cuobjdump -sass of the built K1/K2/K9 library "
                         "to this file (the instructions of the frame loop)")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("gpu_banded_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cuda_lib.build(["viterbi_banded", "obs"])
    libs = build((list(VARIANTS) if "k2" in parts else ["shipped"])
                 + (["k1_clocked", "k1_clocked_floats"] if "k1" in parts else [])
                 + (list(K1_VARIANTS) if "k1variants" in parts else [])
                 + (list(K1_CLUSTER_VARIANTS) if "k1cluster" in parts else []))
    if "k1" in parts:
        k1_frames(libs, dev, args.sass)
    if "k1layouts" in parts:
        k1_layouts(dev, libs["shipped"])
    if "k1variants" in parts:
        k1_variants(libs, dev)
    if "k1cluster" in parts:
        k1_cluster_variants(libs, dev)
    if "obs" in parts:
        clocked_frames(libs["shipped"], dev)
    if "obsparts" in parts:
        obs_parts(dev)
    if "obsdesigns" in parts:
        obs_designs(dev)
    if "k9" in parts:
        k9_layouts(dev)
    if "k2" in parts:
        k2_split(libs, dev)
    if "routes" in parts:
        k2_routes(dev)
    if "voicing" in parts:
        k2_voicing(dev)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
