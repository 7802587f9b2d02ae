// K1 and K2: the banded batched Viterbi forward DP and backtrace for
// Hopper (sm_90a), on the shaped melody transition structure.
//
// K1 replaces viterbi_spl_tpu/hmm/viterbi_banded.py::_make_banded_forward_kernel
// (obs_mode=None; pallas_call at viterbi_banded.py:467). K2 replaces
// viterbi_banded.py::_make_banded_backtrace_kernel (pallas_call at :773).
//
// The structure (see the Python module viterbi_banded.py): the voiced block
// of A is banded (|x - s| <= d_max), the couplings to and from the unvoiced
// state n = S - 1 are constants, and every entry outside the band is exactly
// 0, so log(A + tiny) there is the constant LOG_TINY. The dense max over all
// sources of a voiced target s then equals, bitwise,
//   max( max_{x = s+d valid, |d| <= d_max} T1[x] + logB[s, x],
//        T1[n] + log c_uv,
//        max_voiced(T1) + LOG_TINY )
// and the unvoiced target is max(max_voiced + log c_vu, T1[n] + log c_uu).
// logB[s, x] for an in-band source is read from the source profiles
// bv[cls[d]][x] (d = x - s): classes merge only f32-identical profiles, so
// these are the very values of the dense table. The DP only adds and takes
// maxima — no multiply, hence no FMA contraction — so the result is
// bit-identical to the dense DP and to the NumPy oracle on every state.
//
// What bounds them on this card: K1 reads the log observations once and
// writes the shifted T1 rows once (8 bytes per state and frame), and does
// about 2 (2 d_max + 1) adds and maxima per state and frame; at tonet's
// d_max = 14 the bytes bound it (3.35 TB/s), but each track is a chain of T
// dependent steps, so the floor for one track is T times the latency of one
// step. The design runs one block per track (one thread per state, the
// carry row double-buffered in shared memory, one __syncthreads per frame,
// the voiced max reduced per warp by redux.sync in the step that produces
// the row and across warps in the next), and streams each thread's
// observations through a VSPL_RING-frame shared-memory ring filled by
// cp.async, so that no frame waits on device memory. The profiles (one row
// per class: 8 rows, 11.5 KB for tonet's shaped matrix) live in shared
// memory when they fit and are read through L1 otherwise; the band itself
// (jdc: 81 offsets x 722 states, 234 KB) would not fit the 227 KB a block
// may hold. When the band has at
// most VSPL_BAND_REGS offsets (tonet: 29), each thread copies its own band
// column from the profiles into registers once, so a candidate costs one
// shared-memory load instead of three; the carry rows are padded so the
// fully unrolled loop needs no bounds test; four independent max chains
// shorten the loop's latency. (Unrolling the three-load loop with a masked
// trip count is 1.8x slower on the H100; PERF.md.) Measured on the H100
// (clock64 in every warp; scripts/gpu_banded_probe.py, PERF.md): a 361-state
// frame is ~1,200 SM cycles, ~500 of them the candidate loop and the rest
// the chain of the barrier, the two voiced-max reductions, the stores and
// the observation refill; a 722-state frame (81 offsets, three loads a
// candidate) ~8,600, of which the candidates ~7,100: the shared-memory port.
// Four targets a thread (float4 rows, a quarter of the warps) takes the
// same ~0.62 us a 361-state frame, so that frame is a latency chain.
//
// Where the band does not fit one thread's registers (2 d_max + 1 > 32), K1
// runs a thread-block cluster of C blocks per track instead (C from the
// caller, hmm/viterbi_banded.py::k1_cluster): each block owns ceil(S / C)
// targets, one thread each, with its band column in registers (up to 84
// offsets, so at most 384 threads a block), and values move by st.async
// into mbarrier-counted rows with no barrier a frame; the banded matrix
// needs only d_max values from each neighbouring block, every warp's voiced
// maximum and the unvoiced value. At jdc's 722 states a frame takes ~1.1 us
// (C = 2) against ~4.3 for one block. At 361 states its exchange costs more
// than one block's barrier (0.65-0.8 us a frame against 0.6), so there K1
// keeps one block per track.
//
// K2 has two routes behind one entry, chosen by the caller from the work
// they cost (hmm/viterbi_banded.py::k2_route). A chain that takes the
// argmax over a t1m1 row at every step has that argmax (and the row's
// arrival) on its chain of T dependent steps (~0.5-0.9 us a step on one
// warp, banded_chain_kernel), whatever the number of tracks; it is kept for
// many tracks at many states, and near the crossover for mostly unvoiced
// paths (its step skips the in-band scan at the unvoiced state). Otherwise
// K2 is two kernels, as K8 is:
//   * the backpointer pass writes bp[n, t, s] = the first-max argmax of
//     t1m1[n, t, :] + logB[s, :] for every frame 1 <= t < len and state s
//     over the whole card, tiled (frames x states) a block, from K2's exact
//     split of the row: two first-max argmaxes per row over all sources
//     with their out-of-band values, A_v (voiced sources at LOG_TINY, the
//     unvoiced one at log c_uv) and A_u (log c_vu, log c_uu); the unvoiced
//     target takes A_u, a voiced target the first maximum of its 2 d_max + 1
//     in-band candidates t1m1[x] + bv[cls[x - s + d_max]][x] folded with
//     (A_v, its value) by the full comparison (larger value, then lower
//     index) — its band column in registers, the row in shared memory. An
//     in-band source's out-of-band value is never above its in-band one, so
//     this is the row's own first maximum, bit for bit. It is bound by
//     compare-and-select issue (three half-rate operations a candidate):
//     it does ~2 d_max + 1 times the work of a per-track chain, spread over
//     the whole card, so it wins where a chain per track leaves most SMs
//     idle (few tracks) and loses where many tracks already fill the card
//     (PERF.md). Rows at or beyond a track's length are skipped (K1 leaves
//     them unwritten). bp is int16 (S <= 1024), rows padded to Sp = S
//     rounded up to 8 (16 bytes);
//   * the chase: one thread per track walks s = bp[t][s] over 16-row chunks
//     brought by bulk copies into an mbarrier ring (vspl_chase_kernel,
//     viterbi_common.cuh, shared with K8); a step is one shared-memory load.
//
// K9 replaces the same TPU kernel with obs_mode=("shaun"|"softmax", spw)
// (viterbi_banded.py:247, :266-287): K1 whose observations are computed in
// the block from the raw logits with obs_common.cuh's per-frame function
// instead of read from log_obs. The DP warps run K1's code (the same
// template, kObs set) and synchronise among themselves with a named barrier;
// P producer warps of their own compute whole frames into a
// ring of R frames in shared memory, producer p the frames p, p + P, ...,
// each frame's logits gathered through the reflect map by cp.async one frame
// ahead. A slot is published on its "full" mbarrier (every producer lane
// arrives after its stores) and released on its "empty" one (one DP thread
// arrives after the frame barrier that follows the slot's last read); the DP
// threads wait on frame t's full barrier just before they add its
// observation, so they stall only when the producers fall behind. Every wait
// traps after 2^28 tries. The observations are the bits K5/K6 write (the same
// function), so K9 equals K5/K6 -> K1 bit for bit; it saves K5/K6's write
// and K1's read of the [N, T, S] log observations. What bounds it: K1's
// chain of frames, and the producers' issue slots taken from it (a producer
// warp takes ~7,200 SM cycles over a 361-state frame, the DP ~1,150). P and
// R (R >= P) come from the caller (hmm/viterbi_banded.py::k9_layout);
// log_prior sits in shared memory.

#include <cooperative_groups.h>

#include "obs_common.cuh"

namespace cg = cooperative_groups;

// Shared memory a block may use before the profiles move to L1.
#define VSPL_BANDED_SMEM_BUDGET (200 * 1024)
// In-band offsets a K1 thread can keep in registers.
#define VSPL_BAND_REGS 32
// Threads of a K1/K9 block at most (K9: the DP warps and the producers).
#define VSPL_FORWARD_THREADS 1024

// Floats of one padded K1 carry row.
__host__ __device__ inline int vspl_carry_stride(int S, int d_max) {
  return S + d_max + VSPL_BAND_REGS;
}

// Returned when no group of SMs can hold one cluster of K1's cluster kernel.
#define VSPL_ERR_CLUSTER 10001

extern "C" const char* vspl_error_string(int code) {
  if (code == VSPL_ERR_CLUSTER)
    return "no group of SMs can hold one thread-block cluster of this size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// K1 and K9
// ---------------------------------------------------------------------------

// The DP warps' frame barrier: the whole block for K1, a named barrier over
// the DP warps alone for K9 (its producers never join it).
template <int kObs>
__device__ __forceinline__ void vspl_dp_sync(int dp_threads) {
  if constexpr (kObs == 0)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;\n" ::"r"(dp_threads) : "memory");
}

// K9's producer warp pw of P: frames pw, pw + P, ... < len into ring slot
// r % R. The next frame's logits are gathered (reflect map, cp.async) while
// this one is computed; a slot is written once the DP has released its
// previous frame (empty), and published by every lane's arrival (full).
template <int kModel>
__device__ void banded_obs_producer(const VsplObsArgs& a, const float* logits,
                                    const int* idx_s, float* stage, float* ring,
                                    unsigned long long* full, unsigned long long* empty,
                                    int S, int R, int P, int pw, int len, int lane) {
  const int n_stage = a.n_bins + 2 * a.spw;
  if (pw < len)
    vspl_stage_logits_async(stage, logits + static_cast<size_t>(pw) * a.n_bins, idx_s,
                            n_stage, lane);
  int b = 0;
  for (int r = pw; r < len; r += P) {
    const int rn = r + P;
    if (rn < len)
      vspl_stage_logits_async(stage + (1 - b) * n_stage,
                              logits + static_cast<size_t>(rn) * a.n_bins, idx_s, n_stage, lane);
    else
      vspl_commit_copies();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // frame r's logits
    __syncwarp();
    const int slot = r % R, k = r / R;
    if (k >= 1) vspl_mbar_wait<false>(vspl_smem_addr(&empty[slot]), (k - 1) & 1);
    vspl_obs_frame<kModel>(stage + b * n_stage, ring + slot * S, a, lane);
    vspl_mbar_arrive(vspl_smem_addr(&full[slot]));
    __syncwarp();  // every lane has read stage b before it is refilled
    b ^= 1;
  }
  vspl_wait_all_rows();
}

// kRegBand (2 d_max + 1 <= VSPL_BAND_REGS): each thread keeps its own band
// column in registers and reads one carry value per candidate; otherwise
// it reads the class index, the profile and the carry value per candidate.
// kObs: 0 reads log_obs (K1, R = VSPL_RING); VSPL_OBS_SHAUN /
// VSPL_OBS_SOFTMAX computes the observations from oa.logits (K9; log_obs
// unused) in the producer warps beyond the round_up(S, 32) DP threads, into
// a ring of R frames.
template <bool kRegBand, int kObs>
__global__ void __launch_bounds__(VSPL_FORWARD_THREADS) banded_forward_kernel(
    const float* __restrict__ log_obs,   // [N, T, S]
    const float* __restrict__ bv,        // [n_classes, S] source profiles
    const int* __restrict__ cls,         // [2 d_max + 1] class of offset d
    const float* __restrict__ log_pi,    // [S]
    const int* __restrict__ lengths,     // [N], 1 <= len <= T
    float* __restrict__ t1m1,            // [N, T, S]: row t = T1[t-1], row 0 = 0
    float* __restrict__ t1_last,         // [N, S]
    int T, int S, int d_max, int n_classes, int bv_in_smem, float log_tiny,
    float log_c_uv, float log_c_vu, float log_c_uu, VsplObsArgs oa, int R) {
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  const int W = 2 * d_max + 1;
  const int n = S - 1;  // the unvoiced state
  // two carry rows, each with d_max zero slots before it and
  // VSPL_BAND_REGS after it, so every unrolled in-band read stays in its row
  const int stride = vspl_carry_stride(S, d_max);
  const int dp_warps = (S + 31) >> 5;
  const int dp_threads = dp_warps * 32;
  // K9: the reflect map, the log priors and each producer's two staged frames
  const int n_stage = kObs ? oa.n_bins + 2 * oa.spw : 0;
  const int n_prior = kObs == VSPL_OBS_SOFTMAX ? oa.n_bins : 0;
  const int P = kObs ? static_cast<int>(blockDim.x >> 5) - dp_warps : 0;
  unsigned long long* full = smem_u64;                 // K9: [R]
  unsigned long long* empty = full + (kObs ? R : 0);   // K9: [R]
  float* buf = reinterpret_cast<float*>(empty + (kObs ? R : 0));  // [2][stride]
  float* wmax = buf + 2 * stride;                     // [2][32] warp maxima' keys
  float* obs_ring = wmax + 2 * VSPL_MAX_WARPS;        // [R][S] observations
  int* cls_s = reinterpret_cast<int*>(obs_ring + R * S);           // [W]
  int* idx_s = cls_s + W;                                          // K9: [n_stage]
  float* prior_s = reinterpret_cast<float*>(idx_s + n_stage);      // K9: [n_prior]
  float* stage_s = prior_s + n_prior;                              // K9: [P][2][n_stage]
  float* bv_s = stage_s + 2 * P * n_stage;                         // [C][S]
  const float* prof = bv_in_smem ? bv_s : bv;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = dp_warps;
  const int track = blockIdx.x;
  if constexpr (kObs != 0) {
    if (tid == 0)
      for (int i = 0; i < R; ++i) {
        vspl_mbar_init(vspl_smem_addr(&full[i]), 32);
        vspl_mbar_init(vspl_smem_addr(&empty[i]), 1);
      }
    for (int i = tid; i < n_stage; i += blockDim.x) idx_s[i] = oa.idx[i];
    for (int i = tid; i < n_prior; i += blockDim.x) prior_s[i] = oa.log_prior[i];
  }
  for (int i = tid; i < 2 * stride; i += blockDim.x) buf[i] = 0.0f;
  for (int i = tid; i < W; i += blockDim.x) cls_s[i] = cls[i];
  if (bv_in_smem)
    for (int i = tid; i < n_classes * S; i += blockDim.x) bv_s[i] = bv[i];
  __syncthreads();

  const int len = lengths[track];
  if constexpr (kObs != 0) {
    if (warp >= dp_warps) {
      VsplObsArgs a = oa;
      if (kObs == VSPL_OBS_SOFTMAX) a.log_prior = prior_s;
      banded_obs_producer<kObs>(a, oa.logits + static_cast<size_t>(track) * T * oa.n_bins,
                                idx_s, stage_s + 2 * (warp - dp_warps) * n_stage, obs_ring, full,
                                empty, S, R, P, warp - dp_warps, len, lane);
      return;
    }
  }

  // band[d][s] = logB[s, s + d] for the voiced sources of this target,
  // -inf elsewhere (such a candidate never wins: the seed is finite)
  float band[kRegBand ? VSPL_BAND_REGS : 1];
  if constexpr (kRegBand) {
#pragma unroll
    for (int i = 0; i < VSPL_BAND_REGS; ++i) {
      const int x = tid + i - d_max;
      band[i] = (i < W && tid < n && x >= 0 && x < n) ? prof[cls_s[i] * S + x]
                                                      : -CUDART_INF_F;
    }
  }

  const size_t base = static_cast<size_t>(track) * T * S;
  const float* obs = log_obs + base;
  float* out = t1m1 + base;
  const bool real = tid < S;
  // K9: frame t's ring slot and the parity of its full barrier's phase
  int k9_slot = 0, k9_phase = 0;
  if constexpr (kObs != 0) vspl_mbar_wait<false>(vspl_smem_addr(&full[0]), 0);

  float cur = -CUDART_INF_F;
  if (real) {
    cur = log_pi[tid] + (kObs ? obs_ring[tid] : obs[tid]);  // frame 0 is ring slot 0
    buf[d_max + tid] = cur;
    out[tid] = 0.0f;
  }
  // each warp's voiced maximum, kept as its order key from one warp
  // reduction to the next (no conversion between them on the frame's chain)
  unsigned wv =
      __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? cur : -CUDART_INF_F));
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
    const float max_voiced = vspl_key_value(__reduce_max_sync(
        VSPL_FULL_MASK,
        __float_as_uint(wmax[p * VSPL_MAX_WARPS + (lane < nwarps ? lane : 0)])));
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
    wv = __reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(tid < n ? nv : -CUDART_INF_F));
    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = __uint_as_float(wv);
    p ^= 1;
    if constexpr (kObs == 0) {
      // refill the slot just used (its value is in nv) with frame t + VSPL_RING
      const int r = t + VSPL_RING;
      vspl_stage_one(obs_ring + slot, obs + static_cast<size_t>(min(r, len - 1)) * S + tid,
                     real && r < len);
    }
  }
  if constexpr (kObs == 0) vspl_wait_all_rows();
  if (real) t1_last[static_cast<size_t>(track) * S + tid] = cur;
}

// Launches K1 (kObs = 0) or K9 with one block per track: round_up(S, 32)
// DP threads, and for K9 32 * producers more, with a ring of `ring` frames.
template <int kObs>
static int launch_banded_forward(const float* log_obs, const VsplObsArgs& oa, int producers,
                                 int ring, const float* bv, const int* cls,
                                 const float* log_pi, const int* lengths, float* t1m1,
                                 float* t1_last, int N, int T, int S, int d_max,
                                 int n_classes, float log_tiny, float log_c_uv,
                                 float log_c_vu, float log_c_uu, void* stream) {
  const int dp_threads = ((S + 31) / 32) * 32;
  const int threads = dp_threads + (kObs ? 32 * producers : 0);
  if (threads > VSPL_FORWARD_THREADS || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  // a producer waits on a slot's empty barrier by parity, so it must never be
  // two phases behind: its previous frame (P back) freed a slot R back, which
  // covers the slot's use before last only when R >= P
  if (kObs && (producers < 1 || ring < 2 || ring < producers)) return cudaErrorInvalidValue;
  const int R = kObs ? ring : VSPL_RING;
  const int W = 2 * d_max + 1;
  const int n_stage = kObs ? oa.n_bins + 2 * oa.spw : 0;
  const int n_prior = kObs == VSPL_OBS_SOFTMAX ? oa.n_bins : 0;
  const size_t base_smem =
      (kObs ? 2 * R * sizeof(unsigned long long) : 0) +
      (2 * vspl_carry_stride(S, d_max) + 2 * VSPL_MAX_WARPS + static_cast<size_t>(R) * S) *
          sizeof(float) +
      W * sizeof(int) +
      static_cast<size_t>(n_stage + n_prior + (kObs ? 2 * producers * n_stage : 0)) *
          sizeof(float);
  const size_t bv_bytes = static_cast<size_t>(n_classes) * S * sizeof(float);
  const int bv_in_smem = base_smem + bv_bytes <= VSPL_BANDED_SMEM_BUDGET;
  const size_t smem = base_smem + (bv_in_smem ? bv_bytes : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = W <= VSPL_BAND_REGS ? banded_forward_kernel<true, kObs>
                                    : banded_forward_kernel<false, kObs>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_obs, bv, cls, log_pi, lengths, t1m1, t1_last, T, S, d_max, n_classes,
      bv_in_smem, log_tiny, log_c_uv, log_c_vu, log_c_uu, oa, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vspl_banded_forward(const float* log_obs, const float* bv,
                                   const int* cls, const float* log_pi,
                                   const int* lengths, float* t1m1,
                                   float* t1_last, int N, int T, int S,
                                   int d_max, int n_classes, float log_tiny,
                                   float log_c_uv, float log_c_vu,
                                   float log_c_uu, void* stream) {
  const VsplObsArgs none{};
  return launch_banded_forward<0>(log_obs, none, 0, 0, bv, cls, log_pi, lengths, t1m1,
                                  t1_last, N, T, S, d_max, n_classes, log_tiny, log_c_uv,
                                  log_c_vu, log_c_uu, stream);
}

// K9: model is VSPL_OBS_SHAUN (params: threshold, offset, scale) or
// VSPL_OBS_SOFTMAX (params: vth, prior_uv, -; log_prior [n_bins]); logits
// [N, T, S - 1], idx the [S - 1 + 2 spw] reflect map; `producers` warps
// compute the observations into a ring of `ring` >= producers frames.
extern "C" int vspl_banded_forward_obs(const float* logits, const int* idx,
                                       const float* log_prior, int model, int spw,
                                       float p0, float p1, float p2, int producers, int ring,
                                       const float* bv, const int* cls, const float* log_pi,
                                       const int* lengths, float* t1m1, float* t1_last,
                                       int N, int T, int S, int d_max, int n_classes,
                                       float log_tiny, float log_c_uv, float log_c_vu,
                                       float log_c_uu, void* stream) {
  const int n_bins = S - 1;
  if (n_bins < 2 || n_bins > VSPL_OBS_MAX_BINS || spw < 1 || spw >= n_bins)
    return cudaErrorInvalidValue;
  const VsplObsArgs oa{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  if (model == VSPL_OBS_SHAUN)
    return launch_banded_forward<VSPL_OBS_SHAUN>(nullptr, oa, producers, ring, bv, cls, log_pi,
                                                 lengths, t1m1, t1_last, N, T, S, d_max,
                                                 n_classes, log_tiny, log_c_uv, log_c_vu,
                                                 log_c_uu, stream);
  if (model == VSPL_OBS_SOFTMAX)
    return launch_banded_forward<VSPL_OBS_SOFTMAX>(nullptr, oa, producers, ring, bv, cls,
                                                   log_pi, lengths, t1m1, t1_last, N, T, S,
                                                   d_max, n_classes, log_tiny, log_c_uv,
                                                   log_c_vu, log_c_uu, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K1 over a thread-block cluster a track
// ---------------------------------------------------------------------------

// Band offsets a thread of the cluster kernel holds in registers: 32 (d_max
// <= 15) or VSPL_BAND_REGS_WIDE (d_max <= 41).
#define VSPL_BAND_REGS_WIDE 84
// Threads of a cluster kernel's block at most (so that a thread may hold
// 65,536 / 384 = 170 registers: the wide band takes 84).
#define VSPL_CLUSTER_THREADS 384

// A cluster of C blocks per track (C from the caller: hmm/viterbi_banded.py::
// k1_cluster). Block `rank` owns the targets [rank * chunk, rank * chunk +
// chunk), one thread each, and keeps its targets' band columns in registers
// (kBand offsets from -d_max). Its carry row holds its own targets and the
// d_max sources on each side that its band reads; every value of the row
// arrives by st.async, which completes its bytes on the block's mbarrier for
// the row (two rows, two mbarriers, as K7 in viterbi_window.cu): a thread
// sends its new value to its own block, and to the neighbouring block whose
// band reaches it (the banded matrix needs no other value across blocks);
// each warp's voiced maximum goes to every block (lanes 0..C-1), and the
// unvoiced state's value too. A block waits until the row's bytes have landed
// and runs no barrier a frame. A block can only receive row t + 1 after every
// block sent its warps' maxima of row t, which each warp does after it read
// row t - 1, so two row buffers need no "consumed" barrier.
template <int kBand>
__global__ void __launch_bounds__(VSPL_CLUSTER_THREADS, 1) banded_cluster_kernel(
    const float* __restrict__ log_obs,   // [N, T, S]
    const float* __restrict__ bv,        // [n_classes, S] source profiles
    const int* __restrict__ cls,         // [2 d_max + 1] class of offset d
    const float* __restrict__ log_pi,    // [S]
    const int* __restrict__ lengths,     // [N], 1 <= len <= T
    float* __restrict__ t1m1,            // [N, T, S]: row t = T1[t-1], row 0 = 0
    float* __restrict__ t1_last,         // [N, S]
    int T, int S, int d_max, int chunk, float log_tiny, float log_c_uv, float log_c_vu,
    float log_c_uu) {
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int track = blockIdx.x / C;
  const int n = S - 1;  // the unvoiced state
  const int wpb = static_cast<int>(blockDim.x >> 5);
  // one carry row: source x at x - lo + d_max; d_max slots before the
  // block's targets, kBand after the last thread's, so every unrolled read
  // stays in the row
  const int stride = static_cast<int>(blockDim.x) + d_max + kBand;
  unsigned long long* bar = smem_u64;                     // [2]
  float* rows = reinterpret_cast<float*>(smem_u64 + 2);  // [2][stride]
  float* wmax = rows + 2 * stride;                       // [2][32] warp voiced maxima
  float* uvs = wmax + 2 * VSPL_MAX_WARPS;                // [2] the unvoiced value
  float* ring = uvs + 2;                                 // [VSPL_RING][blockDim] observations
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = rank * chunk;
  const int hi = min(lo + chunk, S);
  const int s = lo + tid;
  const bool real = tid < chunk && s < S;
  // the row's bytes a block receives: its own targets, the halos, every
  // warp's maximum and the unvoiced value
  const int halo_l = rank > 0 ? d_max : 0;
  const int halo_r = rank < C - 1 ? min(d_max, min(S, hi + chunk) - hi) : 0;
  const unsigned row_bytes = 4u * static_cast<unsigned>(hi - lo + halo_l + halo_r + C * wpb + 1);
  const int len = lengths[track];

  if (tid == 0) {
    vspl_mbar_init(vspl_smem_addr(&bar[0]), 1);
    vspl_mbar_init(vspl_smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * stride; i += blockDim.x) rows[i] = 0.0f;
  // band[i] = logB[s, s + i - d_max] for the voiced sources of this voiced
  // target, -inf elsewhere (such a candidate never wins: the seed is finite)
  float band[kBand];
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    const int x = s + i - d_max;
    band[i] = (i <= 2 * d_max && real && s < n && x >= 0 && x < n)
                  ? bv[cls[i] * S + x] : -CUDART_INF_F;
  }
  // where this thread's value goes, row buffer 0 and 1: its own block, the
  // block before (its band reaches s when s < lo + d_max) and the one after
  const bool to_l = real && rank > 0 && s < lo + d_max;
  const bool to_r = real && rank < C - 1 && s >= hi - d_max;
  const int self_i = tid + d_max;
  // (named registers: an array indexed by the row's parity would live in
  // local memory)
  unsigned own0 = 0u, own1 = 0u, ownb0 = 0u, ownb1 = 0u, lft0 = 0u, lft1 = 0u, lftb0 = 0u,
           lftb1 = 0u, rgt0 = 0u, rgt1 = 0u, rgtb0 = 0u, rgtb1 = 0u, wm0 = 0u, wm1 = 0u,
           wmb0 = 0u, wmb1 = 0u;
  if (real) {
    own0 = vspl_map_rank(rows + self_i, rank);
    own1 = vspl_map_rank(rows + stride + self_i, rank);
    ownb0 = vspl_map_rank(&bar[0], rank);
    ownb1 = vspl_map_rank(&bar[1], rank);
  }
  if (to_l) {
    lft0 = vspl_map_rank(rows + self_i + chunk, rank - 1);
    lft1 = vspl_map_rank(rows + stride + self_i + chunk, rank - 1);
    lftb0 = vspl_map_rank(&bar[0], rank - 1);
    lftb1 = vspl_map_rank(&bar[1], rank - 1);
  }
  if (to_r) {
    rgt0 = vspl_map_rank(rows + self_i - chunk, rank + 1);
    rgt1 = vspl_map_rank(rows + stride + self_i - chunk, rank + 1);
    rgtb0 = vspl_map_rank(&bar[0], rank + 1);
    rgtb1 = vspl_map_rank(&bar[1], rank + 1);
  }
  if (lane < C) {  // this warp's maximum, to block `lane`
    wm0 = vspl_map_rank(wmax + rank * wpb + warp, lane);
    wm1 = vspl_map_rank(wmax + VSPL_MAX_WARPS + rank * wpb + warp, lane);
    wmb0 = vspl_map_rank(&bar[0], lane);
    wmb1 = vspl_map_rank(&bar[1], lane);
  }
  const size_t base = static_cast<size_t>(track) * T * S;
  const float* obs = log_obs + base;
  float* out = t1m1 + base;
  // each thread's observations stream through a VSPL_RING-frame ring
  for (int f = 1; f <= VSPL_RING; ++f)
    vspl_stage_one(ring + (f % VSPL_RING) * blockDim.x + tid,
                   obs + static_cast<size_t>(min(f, len - 1)) * S + min(s, n), real && f < len);
  cluster.sync();  // every block's barriers and rows are in place
  if (tid == 0) {
    vspl_mbar_expect(vspl_smem_addr(&bar[0]), row_bytes);
    if (len > 1) vspl_mbar_expect(vspl_smem_addr(&bar[1]), row_bytes);
  }

  // row q's value v of this thread (and the warp's maximum) to every block
  // that reads it
  auto send = [&](int q, float v) {
    if (real) {
      vspl_store_remote(q ? own1 : own0, v, q ? ownb1 : ownb0);
      if (to_l) vspl_store_remote(q ? lft1 : lft0, v, q ? lftb1 : lftb0);
      if (to_r) vspl_store_remote(q ? rgt1 : rgt0, v, q ? rgtb1 : rgtb0);
      if (s == n)
        for (int r = 0; r < C; ++r)
          vspl_store_remote(vspl_map_rank(uvs + q, r), v, vspl_map_rank(&bar[q], r));
    }
    const float w = vspl_warp_max(real && s < n ? v : -CUDART_INF_F);
    if (lane < C) vspl_store_remote(q ? wm1 : wm0, w, q ? wmb1 : wmb0);
  };

  float cur = -CUDART_INF_F;
  if (real) {
    cur = log_pi[s] + obs[s];
    out[s] = 0.0f;
  }
  send(0, cur);
  const int n_wmax = C * wpb;
  for (int t = 1; t < len; ++t) {
    const int r = t - 1, b = r & 1;  // row t - 1 is in buffer b
    const int slot = (t % VSPL_RING) * blockDim.x + tid;
    vspl_wait_oldest_row();  // this thread's observation of frame t
    const float obs_t = real ? ring[slot] : 0.0f;
    vspl_mbar_wait(vspl_smem_addr(&bar[b]), (r >> 1) & 1);
    if (tid == 0 && r + 2 < len) vspl_mbar_expect(vspl_smem_addr(&bar[b]), row_bytes);
    const float* prev = rows + b * stride;
    const float max_voiced = vspl_warp_max(wmax[b * VSPL_MAX_WARPS + (lane < n_wmax ? lane : 0)]);
    const float prev_uv = uvs[b];
    // the in-band candidates (pv[i] = T1[s + i - d_max]), then the seed
    const float* pv = prev + tid;
    float a[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kBand; ++i) a[i % 4] = fmaxf(a[i % 4], pv[i] + band[i]);
    float nv;
    if (s < n)
      nv = fmaxf(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])),
                 fmaxf(max_voiced + log_tiny, prev_uv + log_c_uv)) + obs_t;
    else
      nv = fmaxf(max_voiced + log_c_vu, prev_uv + log_c_uu) + obs_t;
    if (real) out[static_cast<size_t>(t) * S + s] = cur;
    cur = nv;
    send(1 - b, nv);
    // refill the slot just read with frame t + VSPL_RING
    const int f = t + VSPL_RING;
    vspl_stage_one(ring + slot, obs + static_cast<size_t>(min(f, len - 1)) * S + min(s, n),
                   real && f < len);
  }
  if (real) t1_last[static_cast<size_t>(track) * S + s] = cur;
  // every store into this block has landed before it may exit
  if (tid == 0) vspl_mbar_wait(vspl_smem_addr(&bar[(len - 1) & 1]), ((len - 1) >> 1) & 1);
  vspl_wait_all_rows();
  cluster.sync();
}

template <int kBand>
static cudaError_t banded_cluster_config(int S, int d_max, int C, cudaLaunchConfig_t* cfg,
                                         cudaLaunchAttribute* attr) {
  const int chunk = (S + C - 1) / C;
  const int threads = (chunk + 31) / 32 * 32;
  // every block owns a target, halos come from neighbours only, and the
  // warps' maxima fit one warp reduction
  if (C < 1 || C > 8 || threads > VSPL_CLUSTER_THREADS || (C - 1) * chunk >= S ||
      (C > 1 && chunk < d_max) || C * (threads / 32) > VSPL_MAX_WARPS || 2 * d_max + 1 > kBand)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(unsigned long long) +
                      (2 * (threads + d_max + kBand) + 2 * VSPL_MAX_WARPS + 2 +
                       static_cast<size_t>(VSPL_RING) * threads) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(banded_cluster_kernel<kBand>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kBand>
static int launch_banded_cluster(const float* log_obs, const float* bv, const int* cls,
                                 const float* log_pi, const int* lengths, float* t1m1,
                                 float* t1_last, int N, int T, int S, int d_max, int C,
                                 float log_tiny, float log_c_uv, float log_c_vu,
                                 float log_c_uu, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = banded_cluster_config<kBand>(S, d_max, C, &cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(N * C);
  cfg.stream = static_cast<cudaStream_t>(stream);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, banded_cluster_kernel<kBand>, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return VSPL_ERR_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, banded_cluster_kernel<kBand>, log_obs, bv, cls, log_pi, lengths,
                         t1m1, t1_last, T, S, d_max, (S + C - 1) / C, log_tiny, log_c_uv,
                         log_c_vu, log_c_uu);
  if (e != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}

// K1 with `cluster` blocks per track (1..8): each block owns ceil(S /
// cluster) targets; 2 d_max + 1 <= VSPL_BAND_REGS_WIDE.
extern "C" int vspl_banded_forward_cluster(const float* log_obs, const float* bv,
                                           const int* cls, const float* log_pi,
                                           const int* lengths, float* t1m1, float* t1_last,
                                           int N, int T, int S, int d_max, int cluster,
                                           float log_tiny, float log_c_uv, float log_c_vu,
                                           float log_c_uu, void* stream) {
  if (N <= 0 || T <= 0 || S < 3) return cudaErrorInvalidValue;
  if (2 * d_max + 1 <= VSPL_BAND_REGS)
    return launch_banded_cluster<VSPL_BAND_REGS>(log_obs, bv, cls, log_pi, lengths, t1m1,
                                                 t1_last, N, T, S, d_max, cluster, log_tiny,
                                                 log_c_uv, log_c_vu, log_c_uu, stream);
  return launch_banded_cluster<VSPL_BAND_REGS_WIDE>(log_obs, bv, cls, log_pi, lengths, t1m1,
                                                    t1_last, N, T, S, d_max, cluster, log_tiny,
                                                    log_c_uv, log_c_vu, log_c_uu, stream);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// K2's chain, where many tracks fill the card: one warp per track walks its
// T dependent argmax steps, the t1m1 rows streaming through a VSPL_RING-row
// shared-memory ring filled by cp.async (each row requested VSPL_RING steps
// before it is used). The step keeps the loads that depend on the current
// state few and off branches: every source is first taken with its
// out-of-band value (loads that need only the row), then the 2 d_max + 1
// in-band sources with their profile values, one per lane; the argmax is
// two warp reductions (redux.sync). kRegs: row values per lane, S <= 32
// kRegs (VSPL_DISPATCH_ROW_REGS).
template <int kRegs>
__global__ void __launch_bounds__(32) banded_chain_kernel(
    const float* __restrict__ t1m1,        // [N, T, S]
    const float* __restrict__ bv,          // [n_classes, S]
    const int* __restrict__ cls,           // [2 d_max + 1]
    const int* __restrict__ last_states,   // [N]
    const int* __restrict__ lengths,       // [N]
    int* __restrict__ states,              // [N, T]
    int T, int S, int d_max, int n_classes, int bv_in_smem, float log_tiny,
    float log_c_uv, float log_c_vu, float log_c_uu) {
  extern __shared__ float ring[];  // [VSPL_RING][S] t1m1 rows in flight
  // then [2 d_max + 1]: offset of the profile of offset d, cls[d] * S
  int* prof_off = reinterpret_cast<int*>(ring + VSPL_RING * S);
  // then [n_classes][S]: the profiles, when they fit
  float* bv_s = reinterpret_cast<float*>(prof_off + 2 * d_max + 1);
  const float* prof = bv_in_smem ? bv_s : bv;
  const int lane = threadIdx.x;
  const int track = blockIdx.x;
  const int n = S - 1;
  const int W = 2 * d_max + 1;
  const int len = lengths[track];
  const float* rows = t1m1 + static_cast<size_t>(track) * T * S;
  int* out = states + static_cast<size_t>(track) * T;
  int s = last_states[track];
  for (int i = lane; i < W; i += 32) prof_off[i] = cls[i] * S;
  if (bv_in_smem)
    for (int i = lane; i < n_classes * S; i += 32) bv_s[i] = bv[i];

  // rows len-1, len-2, ... (row 0 is never read) start copying, one group each
  for (int i = 0; i < VSPL_RING; ++i) {
    const int r = len - 1 - i;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
  }
  __syncwarp();
  for (int t = len - 1;; --t) {
    if (lane == 0) out[t] = s;
    if (t == 0) break;
    vspl_wait_oldest_row();  // this lane's share of row t has landed
    __syncwarp();            // and every lane's, for (B)'s reads
    const float* cur = ring + (t % VSPL_RING) * S;

    // s_{t-1} = first-max argmax_x (T1[t-1][x] + logB[s_t, x]) over the
    // logB row rebuilt in two parts, each lane keeping the first maximum
    // of its own candidates.
    // (A) Every source x = lane + 32 k with its out-of-band value: LOG_TINY
    // for a voiced x (log c_uv for the unvoiced one), or the unvoiced row
    // when s_t is unvoiced. Exact outside the band; inside it, LOG_TINY <=
    // logB[s_t, x], so the entry is never above that of (B) for the same x
    // and cannot win where (B) does not. Only the constants depend on s_t:
    // the row's loads are issued before the state is known.
    const bool uv = s == n;
    const float r_voiced = uv ? log_c_vu : log_tiny;
    const float r_unvoiced = uv ? log_c_uu : log_c_uv;
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const int x = lane + 32 * k;
      const int xc = min(x, n);
      const float c = x < S ? cur[xc] + (xc == n ? r_unvoiced : r_voiced) : -CUDART_INF_F;
      if (c > best) {  // ascending x: strict > keeps the first maximum
        best = c;
        best_i = x;
      }
    }
    // (B) A voiced s_t's in-band voiced sources x = s_t - d_max + j, lane j
    // (+ 32 m), with their profile values bv[cls[j]][x]. Their indices do
    // not ascend along (A)'s, hence the full first-max comparison.
    if (!uv) {
      for (int j = lane; j < W; j += 32) {
        const int x = s - d_max + j;
        const int xc = min(max(x, 0), n - 1);
        const float c =
            x == xc ? cur[xc] + prof[prof_off[j] + xc] : -CUDART_INF_F;
        if (c > best || (c == best && x < best_i)) {
          best = c;
          best_i = x;
        }
      }
    }
    s = vspl_warp_argmax(best, best_i);
    // refill the slot just read with the row VSPL_RING steps ahead
    const int r = t - VSPL_RING;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
  }
  vspl_wait_all_rows();
}

// The backpointer pass's block: at most kThreads targets (one a thread) and
// kFrames frames; W <= kBand band values a thread in registers (kBand 0:
// each candidate reads its profile value through L1). A thread takes kIlp
// frames at once, as independent argmax chains (4 measured fastest at 32
// band registers, 1 at 96: scripts/gpu_banded_probe.py). Each candidate
// costs an add and three half-rate compare-and-select operations, which
// bound the pass.
template <int kBand>
struct VsplBpTile {
  static constexpr int kThreads = kBand > VSPL_BAND_REGS ? 256 : 384;
  static constexpr int kFrames = kBand > VSPL_BAND_REGS ? 16 : 32;
  static constexpr int kPadHi = kBand > 0 ? kBand : 1;
  static constexpr int kIlp = kBand > VSPL_BAND_REGS ? 1 : 4;
};

// Block (frame tile, state tile, track): the tile's t1m1 rows into shared
// memory (cp.async), each padded with d_max zeros before and kPadHi after;
// warp w takes the two out-of-band argmaxes of rows w, w + warps, ...; then
// thread j writes bp for target s = tile start + j on every row t >= 1.
template <int kBand>
__global__ void __launch_bounds__(VsplBpTile<kBand>::kThreads, kBand > VSPL_BAND_REGS ? 2 : 1)
    banded_backpointers_kernel(const float* __restrict__ t1m1,   // [N, T, S]
                               const float* __restrict__ bv,     // [n_classes, S]
                               const int* __restrict__ cls,      // [2 d_max + 1]
                               const int* __restrict__ lengths,  // [N]
                               short* __restrict__ bp,           // [N, T, Sp], rows 1 <= t < len
                               int T, int S, int Sp, int d_max, int tile, float log_tiny,
                               float log_c_uv, float log_c_vu, float log_c_uu) {
  using Tile = VsplBpTile<kBand>;
  constexpr int F = Tile::kFrames;
  extern __shared__ __align__(16) float bp_smem[];
  const int n = S - 1;
  const int W = 2 * d_max + 1;
  const int track = blockIdx.z;
  const int t0 = blockIdx.x * F;
  const int len = lengths[track];
  if (t0 >= len) return;
  const int nf = min(F, len - t0);
  const int pads = d_max + Tile::kPadHi;
  const int stride = S + pads;
  float* rows = bp_smem;                             // [F][stride]: x at f * stride + d_max + x
  float* vv_s = rows + F * stride;                   // [F] the value of A_v
  int* av_s = reinterpret_cast<int*>(vv_s + F);      // [F] A_v
  int* au_s = av_s + F;                              // [F] A_u
  int* cls_s = au_s + F;                             // [W]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* src = t1m1 + (static_cast<size_t>(track) * T + t0) * S;
  for (int f = 0; f < nf; ++f)
    for (int x = tid; x < S; x += blockDim.x)
      vspl_copy_async(rows + f * stride + d_max + x, src + static_cast<size_t>(f) * S + x);
  vspl_commit_copies();
  // the pads hold zeros: their candidates carry a -inf band value
  for (int i = tid; i < F * pads; i += blockDim.x) {
    const int f = i / pads, k = i % pads;
    rows[f * stride + (k < d_max ? k : S + k)] = 0.0f;
  }
  for (int i = tid; i < W; i += blockDim.x) cls_s[i] = cls[i];
  // band[j] = logB[s, s - d_max + j] for the voiced sources of a voiced
  // target, -inf elsewhere
  const int s = blockIdx.y * tile + tid;
  float band[kBand > 0 ? kBand : 1];
  if constexpr (kBand > 0) {
#pragma unroll
    for (int j = 0; j < kBand; ++j) {
      const int x = s - d_max + j;
      band[j] = (j < W && s < n && x >= 0 && x < n) ? __ldg(bv + __ldg(cls + j) * S + x)
                                                    : -CUDART_INF_F;
    }
  }
  vspl_wait_all_rows();
  __syncthreads();

  // per row, the first-max argmaxes over every source with its out-of-band
  // value: A_v for a voiced target, A_u for the unvoiced one
  for (int f = warp; f < nf; f += nwarps) {
    const float* row = rows + f * stride + d_max;
    float bv_v = -CUDART_INF_F, bv_u = -CUDART_INF_F;
    int iv = 0x7fffffff, iu = 0x7fffffff;
    for (int x = lane; x < S; x += 32) {  // ascending x: strict > keeps the first maximum
      const float r = row[x];
      const float cv = r + (x < n ? log_tiny : log_c_uv);
      const float cu = r + (x < n ? log_c_vu : log_c_uu);
      if (cv > bv_v) {
        bv_v = cv;
        iv = x;
      }
      if (cu > bv_u) {
        bv_u = cu;
        iu = x;
      }
    }
    const int av = vspl_warp_argmax(bv_v, iv);
    const int au = vspl_warp_argmax(bv_u, iu);
    if (lane == 0) {
      av_s[f] = av;
      au_s[f] = au;
      vv_s[f] = row[av] + (av < n ? log_tiny : log_c_uv);
    }
  }
  __syncthreads();
  if (tid >= tile || s >= S) return;

  short* out = bp + (static_cast<size_t>(track) * T + t0) * Sp + s;
  const int f_begin = t0 == 0 ? 1 : 0;
  if (s == n) {
    for (int f = f_begin; f < nf; ++f) out[static_cast<size_t>(f) * Sp] = static_cast<short>(au_s[f]);
    return;
  }
  constexpr int U = Tile::kIlp;
  for (int f0 = f_begin; f0 < nf; f0 += U) {
    // per frame, the in-band candidates in ascending source order (strict >:
    // the first maximum); a frame past the tile repeats the last one
    float best[U];
    int xb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = rows + min(f0 + u, nf - 1) * stride + d_max;
      best[u] = -CUDART_INF_F;
      xb[u] = s;
      if constexpr (kBand > 0) {
        const float* pv = row + s - d_max;  // pv[j] = t1m1[s - d_max + j]
        int bj = d_max;
#pragma unroll
        for (int j = 0; j < kBand; ++j) {
          const float v = pv[j] + band[j];
          if (v > best[u]) {
            best[u] = v;
            bj = j;
          }
        }
        xb[u] = s - d_max + bj;
      } else {
        for (int x = max(0, s - d_max); x <= min(n - 1, s + d_max); ++x) {
          const float v = row[x] + __ldg(bv + cls_s[x - s + d_max] * S + x);
          if (v > best[u]) {
            best[u] = v;
            xb[u] = x;
          }
        }
      }
    }
    // then (A_v, its value) by the full comparison
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + u;
      if (f < nf) {
        const float vv = vv_s[f];
        const int av = av_s[f];
        const int b = (vv > best[u] || (vv == best[u] && av < xb[u])) ? av : xb[u];
        out[static_cast<size_t>(f) * Sp] = static_cast<short>(b);
      }
    }
  }
}

template <int kBand>
static cudaError_t launch_banded_backpointers(const float* t1m1, const float* bv,
                                              const int* cls, const int* lengths, short* bp,
                                              int N, int T, int S, int Sp, int d_max,
                                              float log_tiny, float log_c_uv, float log_c_vu,
                                              float log_c_uu, cudaStream_t stream) {
  using Tile = VsplBpTile<kBand>;
  // state tiles of equal width, a multiple of 32
  const int tiles = (S + Tile::kThreads - 1) / Tile::kThreads;
  const int tile = ((S + tiles - 1) / tiles + 31) / 32 * 32;
  const size_t smem =
      (static_cast<size_t>(Tile::kFrames) * (S + d_max + Tile::kPadHi) + Tile::kFrames) *
          sizeof(float) +
      (2 * Tile::kFrames + 2 * d_max + 1) * sizeof(int);
  auto kernel = banded_backpointers_kernel<kBand>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + Tile::kFrames - 1) / Tile::kFrames, tiles, N);
  kernel<<<grid, tile, smem, stream>>>(t1m1, bv, cls, lengths, bp, T, S, Sp, d_max, tile,
                                       log_tiny, log_c_uv, log_c_vu, log_c_uu);
  return cudaGetLastError();
}

// The pass at the fewest band registers that hold 2 d_max + 1 offsets.
static cudaError_t launch_pass(const float* t1m1, const float* bv, const int* cls,
                               const int* lengths, short* bp, int N, int T, int S, int Sp,
                               int d_max, float log_tiny, float log_c_uv, float log_c_vu,
                               float log_c_uu, cudaStream_t st) {
  const int W = 2 * d_max + 1;
  if (W <= VSPL_BAND_REGS)
    return launch_banded_backpointers<VSPL_BAND_REGS>(t1m1, bv, cls, lengths, bp, N, T, S, Sp,
                                                      d_max, log_tiny, log_c_uv, log_c_vu,
                                                      log_c_uu, st);
  if (W <= 96)
    return launch_banded_backpointers<96>(t1m1, bv, cls, lengths, bp, N, T, S, Sp, d_max,
                                          log_tiny, log_c_uv, log_c_vu, log_c_uu, st);
  return launch_banded_backpointers<0>(t1m1, bv, cls, lengths, bp, N, T, S, Sp, d_max, log_tiny,
                                       log_c_uv, log_c_vu, log_c_uu, st);
}

// K2's chain: one block of one warp per track.
static cudaError_t launch_chain(const float* t1m1, const float* bv, const int* cls,
                                const int* last_states, const int* lengths, int* states, int N,
                                int T, int S, int d_max, int n_classes, float log_tiny,
                                float log_c_uv, float log_c_vu, float log_c_uu,
                                cudaStream_t stream) {
  const size_t base_smem = vspl_ring_bytes(S) + (2 * d_max + 1) * sizeof(int);
  const size_t bv_bytes = static_cast<size_t>(n_classes) * S * sizeof(float);
  const int bv_in_smem = base_smem + bv_bytes <= VSPL_BANDED_SMEM_BUDGET;
  const size_t smem = base_smem + (bv_in_smem ? bv_bytes : 0);
  auto launch = [&](auto kernel) -> cudaError_t {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<N, 32, smem, stream>>>(t1m1, bv, cls, last_states, lengths, states, T, S, d_max,
                                    n_classes, bv_in_smem, log_tiny, log_c_uv, log_c_vu,
                                    log_c_uu);
    return cudaGetLastError();
  };
#define VSPL_LAUNCH(R) launch(banded_chain_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_LAUNCH);
#undef VSPL_LAUNCH
}

// K2, S <= 1024: with bp (scratch [N, T, Sp] int16, Sp = S rounded up to a
// multiple of 8) the backpointer pass into it, launched over at most 65535
// tracks at a time (grid.z), then the chase from last_states at each
// track's frame len - 1; with bp null, the chain. The caller chooses
// (hmm/viterbi_banded.py::k2_route).
extern "C" int vspl_banded_backtrace(const float* t1m1, const float* bv,
                                     const int* cls, const int* last_states,
                                     const int* lengths, int* states, short* bp,
                                     int N, int T, int S, int d_max, int n_classes,
                                     float log_tiny, float log_c_uv, float log_c_vu,
                                     float log_c_uu, void* stream) {
  if (S < 3 || S > 32 * VSPL_ROW_REGS || N <= 0 || T <= 0 || d_max < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bp == nullptr)
    return static_cast<int>(launch_chain(t1m1, bv, cls, last_states, lengths, states, N, T, S,
                                         d_max, n_classes, log_tiny, log_c_uv, log_c_vu,
                                         log_c_uu, st));
  const int Sp = (S + 7) / 8 * 8;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const size_t frames = static_cast<size_t>(n0) * T;
    const cudaError_t e = launch_pass(t1m1 + frames * S, bv, cls, lengths + n0, bp + frames * Sp,
                                      min(65535, N - n0), T, S, Sp, d_max, log_tiny, log_c_uv,
                                      log_c_vu, log_c_uu, st);
    if (e != cudaSuccess) return e;
  }
  return static_cast<int>(vspl_launch_chase<short>(bp, last_states, lengths, states, N, T, Sp,
                                                   st));
}
