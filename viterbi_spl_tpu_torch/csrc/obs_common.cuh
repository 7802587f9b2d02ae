// The fused observation models, one frame per warp (sm_90a): shared by
// K5/K6 (csrc/obs.cu) and K9 (csrc/viterbi_banded.cu), so that K9's log
// observations are the very bits K5/K6 write. Each caller stages a frame's
// reflect-padded logits in shared memory its own way (K9 gathers them from
// device memory, K5/K6 from a bulk-copied tile).
//
// They replace the per-frame bodies of the TPU kernels,
// viterbi_spl_tpu/hmm/obs_pallas.py::shaun_log_obs_block (:90) and
// ::softmax_log_obs_block (:157), step for step, DIRECT in the log domain:
// peak lanes get (x - gmax) + log c floored at log TINY, non-peak lanes
// exactly log TINY, the unvoiced state the exact column arithmetic. A frame
// with no peak gives what the TPU kernel gives: NEG_PAD stands for "no
// peak" (gmax = NEG_PAD, any_peak = gmax > NEG_PAD / 2), and -inf appears
// nowhere.
//
// Exactness between call sites: every multiply that meets an add is an
// explicit __fmul_rn/__fadd_rn (never contracted into an FMA, whatever
// the caller inlines around it), the sums run in a fixed order (ascending
// bins per lane, then a butterfly of warp shuffles whose every lane ends
// with the same value), and expf/logf are the IEEE library functions (no
// __expf/__logf, no --use_fast_math).

#pragma once

#include <cfloat>

#include "viterbi_common.cuh"

#define VSPL_OBS_SHAUN 1
#define VSPL_OBS_SOFTMAX 2
// A lane's peak flags are the bits of one word: n_bins <= 32 * 32.
#define VSPL_OBS_MAX_BINS 1024
#define VSPL_NEG_PAD (-1e30f)

struct VsplObsArgs {
  const float* logits;     // [N, T, n_bins] raw logits
  const int* idx;          // [n_bins + 2 spw]: np.pad(arange(n_bins), spw, "reflect")
  const float* log_prior;  // [n_bins] softmax log priors (zeros unscaled); shaun: unused
  float p0, p1, p2;        // shaun: threshold, log(p/(1-p)), scale; softmax: vth, prior_uv, -
  float log_tiny;          // log(TINY) as numpy computes it in f32
  int n_bins, spw;
};

// Sum across a warp in a fixed order; every lane returns the same value
// (each butterfly step adds the same two values on both lanes, and f32
// addition commutes).
__device__ __forceinline__ float vspl_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(VSPL_FULL_MASK, v, o));
  return v;
}

// stage[j] = row[idx[j]] for the frame's n_stage = n_bins + 2 spw
// reflect-indexed logits (idx in shared memory), by cp.async, committed as
// one group: the warp waits (cp.async.wait_group / wait_all) and
// __syncwarp()s before reading.
__device__ __forceinline__ void vspl_stage_logits_async(float* stage, const float* row,
                                                        const int* idx, int n_stage, int lane) {
  for (int j = lane; j < n_stage; j += 32) vspl_copy_async(stage + j, row + idx[j]);
  vspl_commit_copies();
}

// This lane's sum of expf(x[b] - gmax) over its peak bins b = lane + 32 k
// (the set bits k of `peaks`), in ascending k. A lane walks only its set
// bits, so the warp runs as many exps as its busiest lane has peaks (~1-3
// a frame at the serving shapes) rather than one per bin slot; the terms
// and their order are those of a walk over every slot.
__device__ __forceinline__ float vspl_peak_exp_sum(const float* x, unsigned peaks, float gmax,
                                                   int lane) {
  float sum = 0.0f;
  for (unsigned m = peaks; m != 0u; m &= m - 1u)
    sum = __fadd_rn(sum, expf(__fsub_rn(x[lane + 32 * (__ffs(m) - 1)], gmax)));
  return sum;
}

// One frame's log observations by one warp (all 32 lanes): x_s is the
// staged frame (n_bins + 2 spw floats, the data at [spw, spw + n_bins)),
// out receives S = n_bins + 1 values (voiced bins, then the unvoiced state).
template <int kModel>
__device__ __forceinline__ void vspl_obs_frame(const float* x_s, float* out,
                                               const VsplObsArgs& a, int lane) {
  const int n_bins = a.n_bins;
  const int spw = a.spw;
  // (1) bin b = lane + 32 k is a peak iff x > the max of the spw bins to its
  // left and x >= the max of the spw bins to its right (reflect-padded). The
  // left window of b is the right window of b - spw - 1, so where spw < 32 a
  // lane reads only its bin's right window and takes its left one from the
  // lane holding b - spw - 1 (one shuffle: that lane's value at this k, or
  // at k - 1 where the lane index wraps), half the shared-memory reads.
  // Maxima are exact in any order, so the peaks are the same.
  unsigned peaks = 0;
  float pmax = VSPL_NEG_PAD;
  // max(w[0], ..., w[spw - 1]) in two chains
  auto window = [spw](const float* w) {
    float m0 = w[0], m1 = spw > 1 ? w[1] : w[0];
#pragma unroll 4
    for (int i = 2; i + 1 < spw; i += 2) {
      m0 = fmaxf(m0, w[i]);
      m1 = fmaxf(m1, w[i + 1]);
    }
    if (spw > 2 && (spw & 1)) m0 = fmaxf(m0, w[spw - 1]);
    return fmaxf(m0, m1);
  };
  if (spw < 32) {
    const int src = (lane - spw - 1) & 31;       // the lane holding b - spw - 1
    const bool wraps = lane + spw + 1 >= 32;     // the lane reading mine wants k - 1's
    // the right window of "bin" lane - 32 (k = -1), where a lane reads it
    float r_prev = lane >= 31 - spw ? window(x_s + lane - 32 + spw + 1) : 0.0f;
    for (int k = 0, b = lane; k < (n_bins + 31) >> 5; ++k, b += 32) {
      const float* w = x_s + min(b, n_bins - 1);  // w[spw] the bin, w(spw, 2 spw] right
      const float right = window(w + spw + 1);
      const float left = __shfl_sync(VSPL_FULL_MASK, wraps ? r_prev : right, src);
      r_prev = right;
      const float x = w[spw];
      if (b < n_bins && x > left && x >= right) {
        peaks |= 1u << k;
        pmax = fmaxf(pmax, x);
      }
    }
  } else {
    for (int k = 0, b = lane; b < n_bins; ++k, b += 32) {
      const float* w = x_s + b;  // w[0, spw) left, w[spw] the bin, w(spw, 2 spw] right
      const float x = w[spw];
      if (x > window(w) && x >= window(w + spw + 1)) {
        peaks |= 1u << k;
        pmax = fmaxf(pmax, x);
      }
    }
  }
  pmax = vspl_warp_max(pmax);  // exact in any order
  const bool any_peak = pmax > VSPL_NEG_PAD * 0.5f;

  if constexpr (kModel == VSPL_OBS_SHAUN) {
    const float th = a.p0, offset = a.p1, scale = a.p2;
    const float gmax = pmax;
    const float sign = gmax >= th ? 1.0f : -1.0f;
    const float s = __fadd_rn(__fmul_rn(scale, __fsub_rn(gmax, th)), __fmul_rn(sign, offset));
    const float p_voiced = any_peak ? 1.0f / (1.0f + expf(-s)) : 0.0f;
    // (2) the softmax denominator over the peaks (exp only where selected:
    // x - NEG_PAD would overflow it)
    const float denom = vspl_warp_sum(vspl_peak_exp_sum(x_s + spw, peaks, gmax, lane));
    // (3) log c = log(p_voiced + TINY) - log(max(denom, 1e-30)), per frame
    const float log_c =
        __fsub_rn(logf(__fadd_rn(p_voiced, FLT_MIN)), logf(fmaxf(denom, 1e-30f)));
    for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
      out[b] = ((peaks >> k) & 1u)
                   ? fmaxf(__fadd_rn(__fsub_rn(x_s[spw + b], gmax), log_c), a.log_tiny)
                   : a.log_tiny;
    if (lane == 0) out[n_bins] = logf(__fadd_rn(__fsub_rn(1.0f, p_voiced), FLT_MIN));
  } else {
    const float vth = a.p0, prior_uv = a.p1;
    const float gmax = fmaxf(pmax, vth);  // the non-melody logit is always in the set
    const float sum = vspl_warp_sum(vspl_peak_exp_sum(x_s + spw, peaks, gmax, lane));
    const float exp_nm = expf(__fsub_rn(vth, gmax));
    const float denom = __fadd_rn(sum, exp_nm);
    const float log_denom = logf(denom);
    for (int k = 0, b = lane; b < n_bins; ++k, b += 32)
      out[b] = (((peaks >> k) & 1u) && any_peak)
                   ? fmaxf(__fsub_rn(__fsub_rn(__fsub_rn(x_s[spw + b], gmax), log_denom),
                                     a.log_prior[b]),
                           a.log_tiny)
                   : a.log_tiny;
    if (lane == 0) {
      const float unvoiced = any_peak ? (exp_nm / denom) / prior_uv : 1.0f / prior_uv;
      out[n_bins] = logf(__fadd_rn(unvoiced, FLT_MIN));
    }
  }
}
