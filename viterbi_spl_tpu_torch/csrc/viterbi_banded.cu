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
// trip count is 1.8x slower on the H100; PERF.md.)
//
// K2 is a pointer chase: T dependent argmax steps per track, each over one
// t1m1 row (S floats) plus a rebuilt logB row, so its floor is T times the
// latency of one step. One warp per track; t1m1 rows stream through a
// VSPL_RING-row shared-memory ring filled by cp.async, so each row is
// requested VSPL_RING steps before it is used. The step keeps the loads
// that depend on the current state few and off branches: every source is
// first taken with its out-of-band value (loads that need only the row),
// then the 2 d_max + 1 in-band sources with their profile values, one per
// lane; the argmax is two warp reductions (redux.sync). (A profile load
// per source behind a branch serialises the loads;
// scripts/gpu_backtrace_probe.py measures the alternatives.)

#include "viterbi_common.cuh"

// Shared memory a block may use before the profiles move to L1.
#define VSPL_BANDED_SMEM_BUDGET (200 * 1024)
// In-band offsets a K1 thread can keep in registers.
#define VSPL_BAND_REGS 32

// Floats of one padded K1 carry row.
__host__ __device__ inline int vspl_carry_stride(int S, int d_max) {
  return S + d_max + VSPL_BAND_REGS;
}

extern "C" const char* vspl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kRegBand (2 d_max + 1 <= VSPL_BAND_REGS): each thread keeps its own band
// column in registers and reads one carry value per candidate; otherwise
// it reads the class index, the profile and the carry value per candidate.
template <bool kRegBand>
__global__ void __launch_bounds__(1024) banded_forward_kernel(
    const float* __restrict__ log_obs,   // [N, T, S]
    const float* __restrict__ bv,        // [n_classes, S] source profiles
    const int* __restrict__ cls,         // [2 d_max + 1] class of offset d
    const float* __restrict__ log_pi,    // [S]
    const int* __restrict__ lengths,     // [N], 1 <= len <= T
    float* __restrict__ t1m1,            // [N, T, S]: row t = T1[t-1], row 0 = 0
    float* __restrict__ t1_last,         // [N, S]
    int T, int S, int d_max, int n_classes, int bv_in_smem, float log_tiny,
    float log_c_uv, float log_c_vu, float log_c_uu) {
  extern __shared__ float smem[];
  const int W = 2 * d_max + 1;
  const int n = S - 1;  // the unvoiced state
  // two carry rows, each with d_max zero slots before it and
  // VSPL_BAND_REGS after it, so every unrolled in-band read stays in its row
  const int stride = vspl_carry_stride(S, d_max);
  float* buf = smem;                                  // [2][stride]
  float* wmax = buf + 2 * stride;                     // [2][32] warp voiced maxima
  float* obs_ring = wmax + 2 * VSPL_MAX_WARPS;        // [VSPL_RING][S] observations
  int* cls_s = reinterpret_cast<int*>(obs_ring + VSPL_RING * S);  // [W]
  float* bv_s = reinterpret_cast<float*>(cls_s + W);               // [C][S]
  const float* prof = bv_in_smem ? bv_s : bv;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int track = blockIdx.x;
  for (int i = tid; i < 2 * stride; i += blockDim.x) buf[i] = 0.0f;
  for (int i = tid; i < W; i += blockDim.x) cls_s[i] = cls[i];
  if (bv_in_smem)
    for (int i = tid; i < n_classes * S; i += blockDim.x) bv_s[i] = bv[i];
  __syncthreads();

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

  const int len = lengths[track];
  const size_t base = static_cast<size_t>(track) * T * S;
  const float* obs = log_obs + base;
  float* out = t1m1 + base;
  const bool real = tid < S;

  float cur = -CUDART_INF_F;
  if (real) {
    cur = log_pi[tid] + obs[tid];
    buf[d_max + tid] = cur;
    out[tid] = 0.0f;
  }
  float wv = vspl_warp_max(tid < n ? cur : -CUDART_INF_F);
  if (lane == 0) wmax[warp] = wv;

  // in-band offsets whose source x = s + d is a voiced state
  const int d_lo = max(-d_max, -tid);
  const int d_hi = min(d_max, n - 1 - tid);
  // each thread's observations stream through a VSPL_RING-frame ring in
  // shared memory, requested VSPL_RING frames ahead: a frame takes less
  // than a device-memory load
  for (int r = 1; r <= VSPL_RING; ++r)
    vspl_stage_one(obs_ring + (r % VSPL_RING) * S + tid,
                   obs + static_cast<size_t>(min(r, len - 1)) * S + tid, real && r < len);
  int p = 0;
  for (int t = 1; t < len; ++t) {
    vspl_wait_oldest_row();  // this thread's observation of frame t
    const int slot = (t % VSPL_RING) * S + tid;
    const float obs_t = real ? obs_ring[slot] : 0.0f;
    __syncthreads();
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
      nv = acc + obs_t;
    } else if (tid == n) {
      nv = fmaxf(max_voiced + log_c_vu, prev_uv + log_c_uu) + obs_t;
    }
    if (real) {
      out[static_cast<size_t>(t) * S + tid] = prev[tid];
      buf[(1 - p) * stride + d_max + tid] = nv;
      cur = nv;
    }
    wv = vspl_warp_max(tid < n ? nv : -CUDART_INF_F);
    if (lane == 0) wmax[(1 - p) * VSPL_MAX_WARPS + warp] = wv;
    p ^= 1;
    // refill the slot just used (its value is in nv) with frame t + VSPL_RING
    const int r = t + VSPL_RING;
    vspl_stage_one(obs_ring + slot, obs + static_cast<size_t>(min(r, len - 1)) * S + tid,
                   real && r < len);
  }
  vspl_wait_all_rows();
  if (real) t1_last[static_cast<size_t>(track) * S + tid] = cur;
}

// kRegs: row values per lane, S <= 32 kRegs (VSPL_DISPATCH_ROW_REGS).
template <int kRegs>
__global__ void __launch_bounds__(32) banded_backtrace_kernel(
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

extern "C" int vspl_banded_forward(const float* log_obs, const float* bv,
                                   const int* cls, const float* log_pi,
                                   const int* lengths, float* t1m1,
                                   float* t1_last, int N, int T, int S,
                                   int d_max, int n_classes, float log_tiny,
                                   float log_c_uv, float log_c_vu,
                                   float log_c_uu, void* stream) {
  const int threads = ((S + 31) / 32) * 32;
  if (threads > 1024 || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const int W = 2 * d_max + 1;
  const size_t base_smem =
      (2 * vspl_carry_stride(S, d_max) + 2 * VSPL_MAX_WARPS + VSPL_RING * S) * sizeof(float) +
      W * sizeof(int);
  const size_t bv_bytes = static_cast<size_t>(n_classes) * S * sizeof(float);
  const int bv_in_smem = base_smem + bv_bytes <= VSPL_BANDED_SMEM_BUDGET;
  const size_t smem = base_smem + (bv_in_smem ? bv_bytes : 0);
  auto kernel = W <= VSPL_BAND_REGS ? banded_forward_kernel<true>
                                    : banded_forward_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_obs, bv, cls, log_pi, lengths, t1m1, t1_last, T, S, d_max, n_classes,
      bv_in_smem, log_tiny, log_c_uv, log_c_vu, log_c_uu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vspl_banded_backtrace(const float* t1m1, const float* bv,
                                     const int* cls, const int* last_states,
                                     const int* lengths, int* states, int N,
                                     int T, int S, int d_max, int n_classes,
                                     float log_tiny,
                                     float log_c_uv, float log_c_vu,
                                     float log_c_uu, void* stream) {
  if (S > 32 * VSPL_ROW_REGS || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const size_t base_smem = vspl_ring_bytes(S) + (2 * d_max + 1) * sizeof(int);
  const size_t bv_bytes = static_cast<size_t>(n_classes) * S * sizeof(float);
  const int bv_in_smem = base_smem + bv_bytes <= VSPL_BANDED_SMEM_BUDGET;
  const size_t smem = base_smem + (bv_in_smem ? bv_bytes : 0);
  auto launch = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<N, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        t1m1, bv, cls, last_states, lengths, states, T, S, d_max, n_classes,
        bv_in_smem, log_tiny, log_c_uv, log_c_vu, log_c_uu);
    return static_cast<int>(cudaGetLastError());
  };
#define VSPL_LAUNCH(R) launch(banded_backtrace_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_LAUNCH);
#undef VSPL_LAUNCH
}
