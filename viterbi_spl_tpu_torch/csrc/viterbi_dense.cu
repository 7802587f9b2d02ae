// K3 and K4: the dense batched Viterbi forward DP and backtrace for Hopper
// (sm_90a), for transition matrices without the banded structure (imm's
// analytic matrix, arbitrary matrices). The single-track kernels over
// windows (K7, K8) are in viterbi_window.cu.
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
// depends on the whole previous row, so a track is a chain of frames.
//
// K3 is the forward of K7 (csrc/viterbi_window.cu) with every reset row 0,
// and up to 768 states it runs K7's kernel (vspl_dense_forward_window): the
// table slice held in registers for the whole track, rows signalled by
// arrival (st.async into mbarriers), no barrier a frame, and G = 1-4 tracks
// a cluster so that one slice serves G carry rows a frame when N tracks
// would not fit the card's clusters in one wave (the caller's choice,
// hmm/viterbi_dense.py::k3_tracks_per_cluster). Measured on the H100
// (scripts/gpu_dense_probe.py, PERF.md): 13.1 ms at imm's 722 states, N=16,
// T=4,096, against 44.3 for the kernel below, which streamed its columns
// from L2 every frame. Above 768 states K3 keeps that kernel: a
// thread-block cluster of VSPL_DENSE_CLUSTER blocks shares a track; each
// block streams only its targets' columns of the transposed table
// logA[s'][s] = logB[s][s'] (the threads of a warp read consecutive
// addresses), split over source ranges with four independent max chains
// per thread, reduces the ranges in shared memory, and stores its new
// values into every block's copy of the carry row through distributed
// shared memory; one cluster barrier per frame.
//
// K4 is a chain of dependent argmax steps per track: each reads one t1m1
// row (staged ahead in a shared-memory ring) and one logB row chosen by the
// current state (an L2 hit, which no prefetch can hide), then takes a
// first-max warp argmax; one warp runs a step in ~1 us (~1,860 SM cycles at
// 722 states, clocked by scripts/gpu_dense_probe.py --parts k4clock: the
// row's loads and the compare ~1,100, the next row's cp.async issue ~600).
// A track of T frames as one chain is T steps on one SM, with the card
// idle. So the chase runs in segments of L frames, one warp each, all at
// once: a segment's warp starts W frames above its last frame (at the
// track's last state where that is within reach, else at the first-max
// argmax of T1 there, a guess), chases down through its segment writing
// its states, and takes one step more: the state its chase gives the frame
// below the segment. Chases from different states merge, so after the W
// warm-up steps the guessed chase is often the true one. A second kernel
// makes that exact, one warp per track: it walks the seams from the top
// segment (exact: it starts at the true last state) down; where the true
// state at a segment's last frame differs from the stored one it chases the
// segment again from the true state until the two chases meet (from there
// on they are one chase) or the segment ends. Every state is the one the
// single chain gives, bit for bit; only the time depends on the data: on
// random matrices chases meet within a few steps, on imm's 722-state matrix
// under random observations after tens to hundreds
// (scripts/gpu_dense_probe.py --parts k4seg). A track costs L + W steps and
// its re-chases instead of T steps. The segment length is the host's
// (hmm/viterbi_dense.py::k4_segment_length: as many segments as the card
// holds warps of this kernel at once, at least K4_MIN_SEGMENT frames).

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
        const float* __restrict__ log_obs,   // [N, T, S]
        const float* __restrict__ logA,      // [S, S]: logA[s'][s] = logB[s][s']
        const float* __restrict__ log_pi,    // [S]
        const int* __restrict__ lengths,     // [N], 1 <= len <= T
        float* __restrict__ t1m1,            // [N, T, S]
        float* __restrict__ t1_last,         // [N, S]
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
  const float lpi = owner ? log_pi[s] : 0.0f;
  const int span = (S + groups - 1) / groups;
  const int src_lo = min(g * span, S);
  const int src_hi = min(src_lo + span, S);
  const float* col = logA + min(s, S - 1);

  cluster.sync();  // every block of the cluster has started
  float cur = 0.0f;
  if (owner) {
    cur = lpi + obs[s];
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

// t1m1 rows a segment's warp keeps in flight; its ring has one slot more,
// for the row its step is reading while the next one is staged.
#define VSPL_SEG_AHEAD 8

// The first-max argmax of row(k) + logB[s, x] over x = lane + 32 k < S by
// one warp (every lane returns it): the step of the chase from state s at
// the frame whose t1m1 row `row` gives (row(k): this lane's value x, x
// clamped into the row). The logB row's loads sit behind no branch, so they
// are in flight together; `between` runs after they are issued, before
// their values are needed.
template <int kRegs, typename Row, typename Between>
__device__ __forceinline__ int dense_step(Row row, const float* __restrict__ logB, int s, int S,
                                          int lane, Between between) {
  const float* brow = logB + static_cast<size_t>(s) * S;
  float b[kRegs];
#pragma unroll
  for (int k = 0; k < kRegs; ++k) b[k] = __ldg(brow + min(lane + 32 * k, S - 1));
  between();
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int x = lane + 32 * k;
    const float c = x < S ? row(k) + b[k] : -CUDART_INF_F;
    if (c > best) {
      best = c;
      best_i = x;
    }
  }
  return vspl_warp_argmax(best, best_i);
}

// The first-max argmax of a row of S values by one warp (every lane returns
// it), clamped into [0, S): a segment's guess of its starting state.
template <int kRegs>
__device__ __forceinline__ int dense_row_argmax(const float* __restrict__ row, int S, int lane) {
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int x = lane + 32 * k;
    const float v = x < S ? __ldg(row + min(x, S - 1)) : -CUDART_INF_F;
    if (v > best) {
      best = v;
      best_i = x;
    }
  }
  return min(vspl_warp_argmax(best, best_i), S - 1);
}

// Segment j of track n (block n * K + j, one warp): frames [lo, hi], lo =
// j L, hi = min(lo + L, len) - 1. The chase starts at frame top = min(hi +
// W, len - 1), from the track's last state when top is the last frame and
// from the first-max argmax of T1[top] = t1m1[top + 1] otherwise; it writes
// states[t] for t <= hi and, for lo >= 1, pred[n, j] = its state at frame
// lo - 1. Rows are staged VSPL_SEG_AHEAD steps ahead (cp.async, one group a
// step, empty where no row is left), each issued while the step's logB row
// is in flight.
template <int kRegs>
__global__ void __launch_bounds__(32) dense_segment_kernel(
    const float* __restrict__ t1m1, const float* __restrict__ logB,
    const int* __restrict__ last_states, const int* __restrict__ lengths,
    int* __restrict__ states, int* __restrict__ pred, int T, int S, int L, int K, int W) {
  extern __shared__ float ring[];  // [VSPL_SEG_AHEAD + 1][S]
  constexpr int R = VSPL_SEG_AHEAD + 1;
  const int lane = threadIdx.x;
  const int n = blockIdx.x / K, j = blockIdx.x % K;
  const int len = lengths[n];
  const int lo = j * L;
  if (lo >= len) return;
  const int hi = min(lo + L, len) - 1;
  const int top = min(hi + W, len - 1);
  const int r_lo = max(lo, 1);  // the lowest row a step reads
  const float* rows = t1m1 + static_cast<size_t>(n) * T * S;
  int* out = states + static_cast<size_t>(n) * T;
  auto stage = [&](int r) {
    vspl_stage_row(ring + (r >= r_lo ? r % R : 0) * S, rows + static_cast<size_t>(max(r, 0)) * S,
                   lane, S, r >= r_lo);
  };
  for (int i = 0; i < VSPL_SEG_AHEAD; ++i) stage(top - i);
  const float* above = rows + static_cast<size_t>(min(top + 1, len - 1)) * S;  // T1[top]
  int s = top == len - 1 ? last_states[n] : dense_row_argmax<kRegs>(above, S, lane);
  for (int t = top;; --t) {
    if (t <= hi && lane == 0) out[t] = s;
    if (t == 0) break;
    // row t has landed: at most VSPL_SEG_AHEAD - 1 younger groups pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(VSPL_SEG_AHEAD - 1) : "memory");
    const float* cur = ring + (t % R) * S;
    s = dense_step<kRegs>([&](int k) { return cur[min(lane + 32 * k, S - 1)]; }, logB, s, S,
                          lane, [&] { stage(t - VSPL_SEG_AHEAD); });
    if (t == lo) {
      if (lane == 0) pred[static_cast<size_t>(n) * K + j] = s;
      break;
    }
  }
  vspl_wait_all_rows();
}

// The seams of track n (one warp), walked from the top segment, whose chase
// began at the true last state, down. e is the true state at the last frame
// hi of segment j; where the segment's stored chase agrees there, all of it
// is true and so is pred[n, j]; else the segment is chased again from e,
// its t1m1 rows staged ahead in the ring as the segment kernel does and
// the stored state of the next frame loaded a step ahead, until the two
// chases meet at some frame (below which they are one chase) or the
// segment's first frame, whose step gives the next e. Each segment is
// chased again at most once, from its true state. fixups (or null): the
// frames re-chased, per track.
template <int kRegs>
__global__ void __launch_bounds__(32) dense_seam_kernel(
    const float* __restrict__ t1m1, const float* __restrict__ logB,
    const int* __restrict__ lengths, int* __restrict__ states, const int* __restrict__ pred,
    int* __restrict__ fixups, int T, int S, int L, int K) {
  extern __shared__ float ring[];  // [VSPL_SEG_AHEAD + 1][S]
  constexpr int R = VSPL_SEG_AHEAD + 1;
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int len = lengths[n];
  const int segs = (len + L - 1) / L;
  const float* rows = t1m1 + static_cast<size_t>(n) * T * S;
  int* out = states + static_cast<size_t>(n) * T;
  const int* p = pred + static_cast<size_t>(n) * K;
  int fixed = 0;
  int e = segs > 1 ? p[segs - 1] : 0;
  for (int j = segs - 2; j >= 0; --j) {
    const int lo = j * L, hi = lo + L - 1, r_lo = max(lo, 1);
    int stored = out[hi];
    if (e == stored) {
      e = p[j];
      continue;
    }
    auto stage = [&](int r) {
      vspl_stage_row(ring + (r >= r_lo ? r % R : 0) * S, rows + static_cast<size_t>(max(r, 0)) * S,
                     lane, S, r >= r_lo);
    };
    for (int i = 0; i < VSPL_SEG_AHEAD; ++i) stage(hi - i);
    int s = e;
    bool met = false;
    for (int t = hi;; --t) {
      if (t < hi && s == stored) {  // the two chases meet at frame t
        met = true;
        break;
      }
      const int stored_next = out[max(t - 1, 0)];
      __syncwarp();  // every lane has read out[t] (a step ago) before it is rewritten
      if (lane == 0) out[t] = s;
      ++fixed;
      if (t == 0) break;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(VSPL_SEG_AHEAD - 1) : "memory");
      const float* cur = ring + (t % R) * S;
      s = dense_step<kRegs>([&](int k) { return cur[min(lane + 32 * k, S - 1)]; }, logB, s, S,
                            lane, [&] { stage(t - VSPL_SEG_AHEAD); });
      if (t == lo) break;  // no meeting in this segment: s is the true state at lo - 1
      stored = stored_next;
    }
    e = met ? p[j] : s;
    vspl_wait_all_rows();  // the ring is empty before the next segment stages into it
    __syncwarp();
  }
  if (fixups != nullptr && lane == 0) fixups[n] = fixed;
}

static int launch_dense_forward(const float* log_obs, const float* logA,
                                const float* log_pi, const int* lengths,
                                float* t1m1, float* t1_last, int N, int T, int S,
                                void* stream) {
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

// K3
extern "C" int vspl_dense_forward(const float* log_obs, const float* logA,
                                  const float* log_pi, const int* lengths,
                                  float* t1m1, float* t1_last, int N, int T,
                                  int S, void* stream) {
  return launch_dense_forward(log_obs, logA, log_pi, lengths, t1m1, t1_last, N, T, S,
                              stream);
}

// Dynamic shared memory of a segment's warp: its ring of t1m1 rows.
inline size_t dense_segment_smem(int S) {
  return static_cast<size_t>(VSPL_SEG_AHEAD + 1) * S * sizeof(float);
}

// K4's segment warps an SM holds at once at S states, into *out.
extern "C" int vspl_dense_backtrace_residency(int S, int* out) {
  if (S <= 0 || S > 32 * VSPL_ROW_REGS) return cudaErrorInvalidValue;
  const size_t smem = dense_segment_smem(S);
  auto query = [&](auto kernel) -> int {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, 32, smem);
    return static_cast<int>(e);
  };
#define VSPL_QUERY(R) query(dense_segment_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_QUERY);
#undef VSPL_QUERY
}

// K4: segments of L frames (K = ceil(T / L) a track, one warp each) with W
// warm-up frames, then the seams (when K > 1). pred: scratch [N, K] int32;
// fixups: [N] int32 or null.
extern "C" int vspl_dense_backtrace(const float* t1m1, const float* logB,
                                    const int* last_states, const int* lengths,
                                    int* states, int* pred, int* fixups, int N, int T, int S,
                                    int L, int W, void* stream) {
  if (S <= 0 || S > 32 * VSPL_ROW_REGS || N <= 0 || T <= 0 || L <= 0 || W < 0)
    return cudaErrorInvalidValue;
  const int K = (T + L - 1) / L;
  if (static_cast<long long>(N) * K > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = dense_segment_smem(S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto segments, auto seams) -> int {
    cudaError_t e = cudaFuncSetAttribute(segments, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(seams, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    segments<<<N * K, 32, smem, st>>>(t1m1, logB, last_states, lengths, states, pred, T, S, L, K,
                                       W);
    e = cudaGetLastError();
    if (e != cudaSuccess || (K == 1 && fixups == nullptr)) return e;
    seams<<<N, 32, smem, st>>>(t1m1, logB, lengths, states, pred, fixups, T, S, L, K);
    return static_cast<int>(cudaGetLastError());
  };
#define VSPL_LAUNCH(R) launch(dense_segment_kernel<R>, dense_seam_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_LAUNCH);
#undef VSPL_LAUNCH
}
