// K3 and K4: the dense batched Viterbi forward DP and backtrace for Hopper
// (sm_90a), for transition matrices without the banded structure (imm's
// analytic matrix, arbitrary matrices).
//
// K3 replaces viterbi_spl_tpu/hmm/viterbi_pallas.py::_forward_kernel_batch
// (pallas_call at viterbi_pallas.py:507). K4 replaces
// viterbi_pallas.py::_backtrace_kernel_batch (pallas_call at :558).
//
//   T1[t][s] = max_{s'} (T1[t-1][s'] + logB[s, s']) + log_obs[t][s]
//
// with the same contract as the banded forward: the shifted rows
// t1m1[t] = T1[t-1] (row 0 zeros) and T1 at each track's last frame. The
// backtrace takes s_{t-1} = first-max argmax_x (t1m1[t][x] + logB[s_t, x]),
// which is the argmax the forward step reduced, so no backpointers are
// stored. Only adds and maxima: bit-identical to the NumPy oracle.
//
// What bounds them on this card: K3 does 2 S^2 float operations per frame
// and track (FP32 outside the tensor cores; max-plus has no tensor-core
// form) against 8 S bytes of observations and rows, so operations bound it;
// the transition table (S^2 floats: 0.5 MB at 361 states, 2.1 MB at 722) is
// too large for shared memory but stays in the 50 MB L2, and a frame
// depends on the whole previous row. One block per track would stream the
// whole table from L2 into one SM each frame, bound by that SM's share of
// L2 bandwidth. So a thread-block cluster of VSPL_DENSE_CLUSTER blocks
// shares a track: each block streams only its
// targets' columns of the transposed table logA[s'][s] = logB[s][s'] (the
// threads of a warp read consecutive addresses), split over source ranges
// with four independent max chains per thread, reduces the ranges in shared
// memory, and stores its new values into every block's copy of the carry
// row through distributed shared memory; one cluster barrier per frame.
//
// K4 is a chain of T dependent argmax steps per track; each reads one
// t1m1 row (staged VSPL_RING steps ahead in a shared-memory ring, as in the
// banded backtrace) and one logB row chosen by the current state (an L2
// hit, which no prefetch can hide). One warp per track; the row's loads sit
// behind no branch, so they are in flight together.

#include <cooperative_groups.h>

#include "viterbi_common.cuh"

namespace cg = cooperative_groups;

// Blocks that share one track's forward (a portable cluster size).
#define VSPL_DENSE_CLUSTER 8

extern "C" const char* vspl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One cluster of VSPL_DENSE_CLUSTER blocks per track. Block `rank` owns the
// targets [rank * chunk, (rank + 1) * chunk); its threads are (tx, g):
// target base + tx, and the g-th of `groups` contiguous source ranges. Every
// block keeps the whole carry row, double-buffered in shared memory; each
// new value is stored into every block's next row (distributed shared
// memory), and one cluster barrier per frame publishes the row.
__global__ void __cluster_dims__(VSPL_DENSE_CLUSTER, 1, 1) __launch_bounds__(1024)
    dense_forward_kernel(
        const float* __restrict__ log_obs,  // [N, T, S]
        const float* __restrict__ logA,     // [S, S]: logA[s'][s] = logB[s][s']
        const float* __restrict__ log_pi,   // [S]
        const int* __restrict__ lengths,    // [N], 1 <= len <= T
        float* __restrict__ t1m1,           // [N, T, S]
        float* __restrict__ t1_last,        // [N, S]
        int T, int S, int chunk, int groups) {
  extern __shared__ float smem[];
  float* buf = smem;               // [2][S] carry rows
  float* part = smem + 2 * S;      // [groups][blockDim.x / groups] partial maxima
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx_n = blockDim.x / groups;
  const int tx = threadIdx.x % tx_n;
  const int g = threadIdx.x / tx_n;
  const int track = blockIdx.x / VSPL_DENSE_CLUSTER;
  const int s = rank * chunk + tx;
  const bool owner = g == 0 && tx < chunk && s < S;  // writes target s
  const int len = lengths[track];
  const size_t base = static_cast<size_t>(track) * T * S;
  const float* obs = log_obs + base;
  float* out = t1m1 + base;
  const int span = (S + groups - 1) / groups;
  const int src_lo = min(g * span, S);
  const int src_hi = min(src_lo + span, S);
  const float* col = logA + min(s, S - 1);

  cluster.sync();  // every block of the cluster has started
  float cur = 0.0f;
  if (owner) {
    cur = log_pi[s] + obs[s];
    out[s] = 0.0f;
    for (int r = 0; r < VSPL_DENSE_CLUSTER; ++r) cluster.map_shared_rank(buf, r)[s] = cur;
  }
  cluster.sync();
  float obs_next = (owner && len > 1) ? obs[S + s] : 0.0f;
  int p = 0;
  for (int t = 1; t < len; ++t) {
    const float obs_t = obs_next;
    if (owner && t + 1 < len) obs_next = obs[static_cast<size_t>(t + 1) * S + s];
    const float* prev = buf + p * S;
    float a0 = -CUDART_INF_F, a1 = -CUDART_INF_F, a2 = -CUDART_INF_F, a3 = -CUDART_INF_F;
    int sp = src_lo;
    for (; sp + 4 <= src_hi; sp += 4) {
      a0 = fmaxf(a0, prev[sp] + __ldg(col + static_cast<size_t>(sp) * S));
      a1 = fmaxf(a1, prev[sp + 1] + __ldg(col + static_cast<size_t>(sp + 1) * S));
      a2 = fmaxf(a2, prev[sp + 2] + __ldg(col + static_cast<size_t>(sp + 2) * S));
      a3 = fmaxf(a3, prev[sp + 3] + __ldg(col + static_cast<size_t>(sp + 3) * S));
    }
    for (; sp < src_hi; ++sp)
      a0 = fmaxf(a0, prev[sp] + __ldg(col + static_cast<size_t>(sp) * S));
    part[g * tx_n + tx] = fmaxf(fmaxf(a0, a1), fmaxf(a2, a3));
    __syncthreads();
    if (owner) {
      float m = part[tx];
      for (int h = 1; h < groups; ++h) m = fmaxf(m, part[h * tx_n + tx]);
      const float nv = m + obs_t;
      out[static_cast<size_t>(t) * S + s] = prev[s];
      for (int r = 0; r < VSPL_DENSE_CLUSTER; ++r)
        cluster.map_shared_rank(buf, r)[(1 - p) * S + s] = nv;
      cur = nv;
    }
    // publishes the next row to every block; also orders this frame's
    // reads of part and of the row before the next frame's writes
    cluster.sync();
    p ^= 1;
  }
  if (owner) t1_last[static_cast<size_t>(track) * S + s] = cur;
}

// kRegs: row values per lane, S <= 32 kRegs (VSPL_DISPATCH_ROW_REGS).
template <int kRegs>
__global__ void __launch_bounds__(32) dense_backtrace_kernel(
    const float* __restrict__ t1m1,       // [N, T, S]
    const float* __restrict__ logB,       // [S, S]
    const int* __restrict__ last_states,  // [N]
    const int* __restrict__ lengths,      // [N]
    int* __restrict__ states,             // [N, T]
    int T, int S) {
  extern __shared__ float ring[];  // [VSPL_RING][S] t1m1 rows in flight
  const int lane = threadIdx.x;
  const int track = blockIdx.x;
  const int len = lengths[track];
  const float* rows = t1m1 + static_cast<size_t>(track) * T * S;
  int* out = states + static_cast<size_t>(track) * T;
  int s = last_states[track];

  for (int i = 0; i < VSPL_RING; ++i) {
    const int r = len - 1 - i;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
  }
  for (int t = len - 1;; --t) {
    if (lane == 0) out[t] = s;
    if (t == 0) break;
    vspl_wait_oldest_row();  // row t has landed
    const float* cur = ring + (t % VSPL_RING) * S;
    const float* brow = logB + static_cast<size_t>(s) * S;
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
    // the row's loads first, none behind a branch (x clamped into the
    // row, the tail masked after), so that they are all in flight at once
    float row[kRegs];
#pragma unroll
    for (int k = 0; k < kRegs; ++k) row[k] = __ldg(brow + min(lane + 32 * k, S - 1));
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const int x = lane + 32 * k;
      const float c = x < S ? cur[min(x, S - 1)] + row[k] : -CUDART_INF_F;
      if (c > best) {
        best = c;
        best_i = x;
      }
    }
    s = vspl_warp_argmax(best, best_i);
    const int r = t - VSPL_RING;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
  }
  vspl_wait_all_rows();
}

extern "C" int vspl_dense_forward(const float* log_obs, const float* logA,
                                  const float* log_pi, const int* lengths,
                                  float* t1m1, float* t1_last, int N, int T,
                                  int S, void* stream) {
  // targets per block, rounded up to warps; the rest of the 1024 threads
  // split the sources
  const int chunk = (S + VSPL_DENSE_CLUSTER - 1) / VSPL_DENSE_CLUSTER;
  const int tx_n = ((chunk + 31) / 32) * 32;
  if (tx_n > 1024 || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const int groups = 1024 / tx_n;
  const int threads = tx_n * groups;
  const size_t smem = (2 * S + threads) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dense_forward_kernel<<<N * VSPL_DENSE_CLUSTER, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      log_obs, logA, log_pi, lengths, t1m1, t1_last, T, S, chunk, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vspl_dense_backtrace(const float* t1m1, const float* logB,
                                    const int* last_states, const int* lengths,
                                    int* states, int N, int T, int S,
                                    void* stream) {
  if (S > 32 * VSPL_ROW_REGS || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const size_t smem = vspl_ring_bytes(S);
  auto launch = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<N, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        t1m1, logB, last_states, lengths, states, T, S);
    return static_cast<int>(cudaGetLastError());
  };
#define VSPL_LAUNCH(R) launch(dense_backtrace_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_LAUNCH);
#undef VSPL_LAUNCH
}
