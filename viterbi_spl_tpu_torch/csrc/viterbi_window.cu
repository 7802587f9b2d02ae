// K7 and K8 for Hopper (sm_90a): the dense forward DP and the chase over
// windows of one track, as the single-track and sequence-parallel decodes
// cut them. Each window has its own length, reset row and start state, and
// one launch runs every window a device holds.
//
// K7 replaces viterbi_spl_tpu/hmm/viterbi_pallas.py::_forward_kernel
// (pallas_call at viterbi_pallas.py:238): the single-track forward with a
// reset row,
//
//   T1[t][s] = max_{s'} (T1[t-1][s'] + logB[s, s']) + log_obs[t][s],
//
// frame 0 from log_pi + obs when the reset row is 0 and from obs alone (a
// cold start) otherwise, and at frame t == reset row the carry restarts from
// log_pi + obs[t], overriding the DP step. It writes t1m1[t] = T1[t-1] (row 0
// zeros) below each window's length and T1 at the window's last frame.
//
// What bounds K7: 2 S^2 FP32 operations per frame, through a chain of frames
// that each depend on the whole previous row, so the time is the per-frame
// chain: the candidates' adds and maxima, the reduction across the lanes
// that share a target, the stores of the new values into every block of the
// cluster, and the wait until a block holds the whole next row (measured at
// 361 states: ~60 % the warps' issue from a row's arrival to their stores,
// ~40 % the exchange; scripts/gpu_window_probe.py's clocked variant). The
// design:
//   * one thread-block cluster per window; cluster size from S by a fixed
//     rule: 8 blocks for S <= 384, 16 (a non-portable cluster) for
//     S <= 768, so that a block owns at most 48 targets; fewer blocks where
//     a small S would leave a block without a target;
//   * the block's slice of the table (its targets' rows of logB, 66 KB at
//     361 states, 133 KB at 722) is read once per window, padded to
//     64 kVec sources, and held on chip for the whole window: in registers,
//     as float4s, 24 floats a thread at 361 states and 48 at 722. Reading it
//     from shared memory every frame would move 66-141 KB of shared memory
//     per frame (520-1,100 cycles at 128 bytes a clock), more than the rest
//     of the frame; registers take no shared-memory bandwidth;
//   * a warp owns two targets, each shared by 16 lanes that take interleaved
//     float4 slots of the sources: the previous row is read as float4s, the
//     16 lanes of a half reading 256 contiguous bytes (no bank conflict);
//     four max chains a lane, then one redux.sync per target on
//     order-preserving keys (exact, order-free);
//   * no barrier per frame: lanes 0..C-1 of each half store the new value
//     into block (lane)'s next carry row with st.async, which completes 4
//     bytes of the transaction count on that block's mbarrier for the row;
//     a block waits on its own mbarrier until all S values of the row have
//     landed (a warp's two values in one 8-byte store, half the remote
//     stores, measured no faster: scripts/gpu_window_probe.py). Two row
//     buffers need no "consumed" barrier: a block can only
//     receive row t+1 after every block sent row t, which each warp does
//     only after it has read row t-1 (a warp whose targets are all padding
//     sits the loop out). One cluster barrier at the start, one before
//     exit, so that no block leaves while its shared memory can still be
//     written;
//   * observations through a 16-frame cp.async ring; only adds and maxima
//     (no FMA contraction, no fast math): bit-equal to the plain version;
//   * the same kernel is K3 (csrc/viterbi_dense.cu), every reset row 0, with
//     kG = 1-4 windows a cluster: the slice in registers serves each of
//     their rows a frame (a frame of G rows costs ~1 + 0.7 (G - 1) frames of
//     one), which fills the card where one window a cluster would need more
//     waves (the card holds 15 8-block and 7 16-block clusters at once).
//
// K8 replaces viterbi_pallas.py::_backtrace_kernel (pallas_call at :303): from
// start_states[n] at frame len - 1, s_{t-1} = first-argmax_x (t1m1[t][x] +
// logB[s_t, x]). A chase that loads logB[s_t, :] has a load chosen by the
// previous step on its chain, which no prefetch can hide (~0.65 us a step on
// one warp). So K8 is two launches behind one entry:
//   * the backpointer pass: bp[n, t, s] = first-argmax_x (t1m1[n, t, x] +
//     logB[s, x]) for every frame 1 <= t < len and state s, a max-plus
//     product with argmax tiled 64 frames x 64 states a block over the whole
//     card; each thread keeps 4 x 4 (value, index) pairs and takes the
//     sources in ascending order with a strict compare, so each bp is the
//     first maximum, the chase's own argmax, bit for bit. It is bound by its
//     operations: S^2 candidates a frame, four instructions each (add,
//     compare, two selects), far above the least work of the chase;
//   * the chase: one thread per window walks s = bp[t][s]; the bp rows do
//     not depend on the state, so they arrive ahead in a ring of 16-row
//     chunks, each one bulk copy (cp.async.bulk) completing on an mbarrier,
//     and a step is one shared-memory load (vspl_chase_kernel in
//     viterbi_common.cuh, shared with K2).

#include <cooperative_groups.h>

#include "viterbi_common.cuh"

namespace cg = cooperative_groups;

// Targets a block owns at most (two per warp).
#define VSPL_WIN_CHUNK 48
// Lanes that share one target's sources (a half warp).
#define VSPL_WIN_LANES 16
// Returned when no group of SMs can hold one cluster of the size S needs.
#define VSPL_ERR_CLUSTER 10001

// Backpointer pass tile: frames x states a block, sources a step.
#define VSPL_BP_FT 64
#define VSPL_BP_FS 64
#define VSPL_BP_KX 32

extern "C" const char* vspl_error_string(int code) {
  if (code == VSPL_ERR_CLUSTER)
    return "no group of SMs can hold one thread-block cluster of the size this state count needs";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// One cluster per kG windows (windows cluster * kG + i, i < kG, those below
// N): the block's slice of the table, held in registers, serves each of
// their carry rows a frame. Block `rank` owns the targets [rank * chunk,
// (rank + 1) * chunk); warp w the local targets 2w and 2w + 1, lane l the
// target 2w + l / 16 and the float4 source slots (l % 16) + 16 k, k < kVec
// (S <= 64 kVec). Shared memory: two mbarriers, the carry rows [2][kG][P]
// (P = 64 kVec, padding at -inf) and the observation ring [VSPL_RING][kG][2
// warps]. A row's mbarrier counts the bytes of the windows still running
// at that row (their lengths may differ). reset_rows null: every reset row
// is 0 (K3).
template <int kVec, int kG>
__global__ void __launch_bounds__(32 * VSPL_WIN_CHUNK / 2, 1) window_forward_kernel(
    const float* __restrict__ log_obs,   // [N, W, S]
    const float* __restrict__ logB,      // [S, S]
    const float* __restrict__ log_pi,    // [S]
    const int* __restrict__ lengths,     // [N], 1 <= len <= W
    const int* __restrict__ reset_rows,  // [N], -1 <= row < len; or null
    float* __restrict__ t1m1,            // [N, W, S]
    float* __restrict__ t1_last,         // [N, S]
    int N, int W, int S, int chunk) {
  constexpr int P = 64 * kVec;
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  unsigned long long* bar = smem_u64;                          // [2]
  float* rows = reinterpret_cast<float*>(smem_u64 + 2);         // [2][kG][P]
  float* ring = rows + 2 * kG * P;                              // [VSPL_RING][kG][2 warps]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int win0 = blockIdx.x / C * kG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane & (VSPL_WIN_LANES - 1);
  const int j = 2 * warp + (lane >> 4);  // local target
  const int s = rank * chunk + j;
  const bool real = j < chunk && s < S;
  const bool in_loop = rank * chunk + 2 * warp < S;  // the warp's first target is real
  const bool sender = real && g < C;                 // sends target s to block g
  const bool keeper = real && g == 0;                // stages obs, writes t1m1 and t1_last
  const int ring_w = blockDim.x / 16;                // ring row: one slot per target
  int len[kG], reset[kG];
  int max_len = 0;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const bool here = win0 + i < N;
    len[i] = here ? lengths[win0 + i] : 0;
    reset[i] = here && reset_rows ? reset_rows[win0 + i] : 0;
    max_len = max(max_len, len[i]);
  }
  // row r's bytes: S values of each window still running at r
  auto row_bytes = [&](int r) {
    unsigned b = 0;
#pragma unroll
    for (int i = 0; i < kG; ++i) b += r < len[i] ? static_cast<unsigned>(S) * 4u : 0u;
    return b;
  };
  const size_t base = static_cast<size_t>(win0) * W * S;
  const float* obs = log_obs + base;  // window win0 + i at obs + i W S
  float* out = t1m1 + base;

  if (threadIdx.x == 0) {
    vspl_mbar_init(vspl_smem_addr(&bar[0]), 1);
    vspl_mbar_init(vspl_smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * kG * P; i += blockDim.x) rows[i] = -CUDART_INF_F;
  // the table slice, once per window: padding sources add 0 to a -inf row
  float4 tab[kVec];
  const float* brow = logB + static_cast<size_t>(min(s, S - 1)) * S;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int x = 4 * (g + VSPL_WIN_LANES * k);
    tab[k].x = x < S ? __ldg(brow + x) : 0.0f;
    tab[k].y = x + 1 < S ? __ldg(brow + x + 1) : 0.0f;
    tab[k].z = x + 2 < S ? __ldg(brow + x + 2) : 0.0f;
    tab[k].w = x + 3 < S ? __ldg(brow + x + 3) : 0.0f;
  }
  // where this lane's stores go: window 0's row buffer 0 or 1 of block g,
  // and its mbarrier (named registers: an array indexed by the frame would
  // live in local memory); window i's row is i P floats further
  unsigned row0 = 0u, row1 = 0u, bar0 = 0u, bar1 = 0u;
  if (sender) {
    row0 = vspl_map_rank(rows + s, g);
    row1 = vspl_map_rank(rows + kG * P + s, g);
    bar0 = vspl_map_rank(&bar[0], g);
    bar1 = vspl_map_rank(&bar[1], g);
  }
  const float lpi = real ? log_pi[s] : 0.0f;
  // the keeper's observations of frame f, one copy group for every window
  auto stage = [&](int f) {
    if (keeper)
#pragma unroll
      for (int i = 0; i < kG; ++i)
        if (f < len[i])
          vspl_copy_async(ring + ((f % VSPL_RING) * kG + i) * ring_w + j,
                          obs + (static_cast<size_t>(i) * W + f) * S + s);
    vspl_commit_copies();
  };
  for (int f = 1; f <= VSPL_RING; ++f) stage(f);
  cluster.sync();  // every block's barriers and padding are in place
  if (threadIdx.x == 0) {
    vspl_mbar_expect(vspl_smem_addr(&bar[0]), row_bytes(0));
    if (max_len > 1) vspl_mbar_expect(vspl_smem_addr(&bar[1]), row_bytes(1));
  }
  // frame 0: with reset row 0, log_pi + obs; otherwise a cold start
  float cur[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const float* ob = obs + static_cast<size_t>(i) * W * S;
    cur[i] = real && len[i] > 0 ? (reset[i] == 0 ? lpi + ob[s] : ob[s]) : 0.0f;
    if (sender && len[i] > 0) vspl_store_remote(row0 + 4u * i * P, cur[i], bar0);
    if (keeper && len[i] > 0) out[static_cast<size_t>(i) * W * S + s] = 0.0f;
  }

  if (in_loop) {
    for (int t = 1; t < max_len; ++t) {
      const int r = t - 1, b = r & 1;  // row t - 1 is in buffer b
      vspl_wait_oldest_row();          // frame t's observations (the keeper's copies)
      __syncwarp();
      vspl_mbar_wait(vspl_smem_addr(&bar[b]), (r >> 1) & 1);
      if (threadIdx.x == 0 && r + 2 < max_len)
        vspl_mbar_expect(vspl_smem_addr(&bar[b]), row_bytes(r + 2));
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        if (kG > 1 && t >= len[i]) continue;  // the same for every thread of the cluster
        const float obs_t = ring[((t % VSPL_RING) * kG + i) * ring_w + j];
        const float4* prev = reinterpret_cast<const float4*>(rows + (b * kG + i) * P);
        float a0 = -CUDART_INF_F, a1 = -CUDART_INF_F, a2 = -CUDART_INF_F, a3 = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float4 v = prev[g + VSPL_WIN_LANES * k];
          a0 = fmaxf(a0, v.x + tab[k].x);
          a1 = fmaxf(a1, v.y + tab[k].y);
          a2 = fmaxf(a2, v.z + tab[k].z);
          a3 = fmaxf(a3, v.w + tab[k].w);
        }
        const unsigned key = vspl_order_key(fmaxf(fmaxf(a0, a1), fmaxf(a2, a3)));
        const unsigned k0 = __reduce_max_sync(VSPL_FULL_MASK, lane < 16 ? key : 0u);
        const unsigned k1 = __reduce_max_sync(VSPL_FULL_MASK, lane < 16 ? 0u : key);
        const float m = vspl_key_value(lane < 16 ? k0 : k1);
        const float nv = t == reset[i] ? lpi + obs_t : m + obs_t;
        if (sender) vspl_store_remote((b ? row0 : row1) + 4u * i * P, nv, b ? bar0 : bar1);
        if (keeper) out[(static_cast<size_t>(i) * W + t) * S + s] = cur[i];
        cur[i] = nv;
      }
      // refill the ring slots just read with frame t + VSPL_RING
      stage(t + VSPL_RING);
    }
  }
#pragma unroll
  for (int i = 0; i < kG; ++i)
    if (keeper && len[i] > 0) t1_last[static_cast<size_t>(win0 + i) * S + s] = cur[i];
  // every store into this block has landed before it may exit
  if (threadIdx.x == 0)
    vspl_mbar_wait(vspl_smem_addr(&bar[(max_len - 1) & 1]), ((max_len - 1) >> 1) & 1);
  vspl_wait_all_rows();
  cluster.sync();
}

// K7's targets a block owns at S states.
static int window_chunk(int S) {
  // the cluster size rule: 8 blocks while a block's share is at most
  // VSPL_WIN_CHUNK targets, else 16
  const int c0 = S <= 8 * VSPL_WIN_CHUNK ? 8 : 16;
  return (S + c0 - 1) / c0;
}

// K7's cluster size at S states: as many blocks as have a target.
extern "C" int vspl_window_cluster_size(int S) {
  const int chunk = window_chunk(S);
  return (S + chunk - 1) / chunk;
}

// K7's launch config at S states with kG windows a cluster (grid unset).
template <int kVec, int kG>
static cudaError_t window_forward_config(int S, cudaLaunchConfig_t* cfg,
                                         cudaLaunchAttribute* attr) {
  const int chunk = window_chunk(S);
  const int C = vspl_window_cluster_size(S);
  const int warps = (chunk + 1) / 2;
  const size_t smem = 2 * sizeof(unsigned long long) +
                      (2 * kG * 64 * kVec + VSPL_RING * kG * 2 * warps) * sizeof(float);
  auto kernel = window_forward_kernel<kVec, kG>;
  cudaError_t e = cudaSuccess;
  if (C > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->blockDim = dim3(32 * warps);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kVec, int kG>
static int launch_window_forward(const float* log_obs, const float* logB,
                                 const float* log_pi, const int* lengths,
                                 const int* reset_rows, float* t1m1, float* t1_last,
                                 int N, int W, int S, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = window_forward_config<kVec, kG>(S, &cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((N + kG - 1) / kG * vspl_window_cluster_size(S));
  cfg.stream = stream;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, window_forward_kernel<kVec, kG>, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return VSPL_ERR_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, window_forward_kernel<kVec, kG>, log_obs, logB, log_pi, lengths,
                         reset_rows, t1m1, t1_last, N, W, S, window_chunk(S));
  if (e != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}

// The kernel for S states (S <= 768) and kG windows a cluster.
template <int kG>
static int launch_window_forward_g(const float* log_obs, const float* logB,
                                   const float* log_pi, const int* lengths,
                                   const int* reset_rows, float* t1m1, float* t1_last, int N,
                                   int W, int S, cudaStream_t st) {
  if (S <= 64 * 2)
    return launch_window_forward<2, kG>(log_obs, logB, log_pi, lengths, reset_rows, t1m1,
                                        t1_last, N, W, S, st);
  if (S <= 64 * 6)
    return launch_window_forward<6, kG>(log_obs, logB, log_pi, lengths, reset_rows, t1m1,
                                        t1_last, N, W, S, st);
  return launch_window_forward<12, kG>(log_obs, logB, log_pi, lengths, reset_rows, t1m1,
                                       t1_last, N, W, S, st);
}

// K7: N windows of W rows, each with its length and reset row; S <= 768.
// logB[s][s'] is the transition score from s' to s (not transposed).
extern "C" int vspl_window_forward(const float* log_obs, const float* logB,
                                   const float* log_pi, const int* lengths,
                                   const int* reset_rows, float* t1m1,
                                   float* t1_last, int N, int W, int S,
                                   void* stream) {
  if (N <= 0 || W <= 0 || S <= 0 || S > 64 * 12 || reset_rows == nullptr)
    return cudaErrorInvalidValue;
  return launch_window_forward_g<1>(log_obs, logB, log_pi, lengths, reset_rows, t1m1, t1_last,
                                    N, W, S, static_cast<cudaStream_t>(stream));
}

// K3 on K7's kernel: N tracks of up to T frames from log_pi (every reset row
// 0), `tracks` (1..4) of them a cluster; S <= 768.
extern "C" int vspl_dense_forward_window(const float* log_obs, const float* logB,
                                         const float* log_pi, const int* lengths,
                                         float* t1m1, float* t1_last, int N, int T, int S,
                                         int tracks, void* stream) {
  if (N <= 0 || T <= 0 || S <= 0 || S > 64 * 12) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tracks) {
    case 1: return launch_window_forward_g<1>(log_obs, logB, log_pi, lengths, nullptr, t1m1,
                                              t1_last, N, T, S, st);
    case 2: return launch_window_forward_g<2>(log_obs, logB, log_pi, lengths, nullptr, t1m1,
                                              t1_last, N, T, S, st);
    case 3: return launch_window_forward_g<3>(log_obs, logB, log_pi, lengths, nullptr, t1m1,
                                              t1_last, N, T, S, st);
    case 4: return launch_window_forward_g<4>(log_obs, logB, log_pi, lengths, nullptr, t1m1,
                                              t1_last, N, T, S, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int kVec>
static int window_max_clusters(int S, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const cudaError_t e = window_forward_config<kVec, 1>(S, &cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(vspl_window_cluster_size(S) * 1024);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, window_forward_kernel<kVec, 1>, &cfg));
}

// How many of K7's clusters (one window a cluster) the card holds at once at
// S states, into *out (0 where no group of SMs holds one).
extern "C" int vspl_window_max_clusters(int S, int* out) {
  if (S <= 0 || S > 64 * 12) return cudaErrorInvalidValue;
  if (S <= 64 * 2) return window_max_clusters<2>(S, out);
  if (S <= 64 * 6) return window_max_clusters<6>(S, out);
  return window_max_clusters<12>(S, out);
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// The backpointer pass: block (frame tile, state tile, window); thread
// (ty, tx) of 16 x 16 keeps frames ty*4 + i and states tx*4 + c. Sources in
// steps of VSPL_BP_KX through shared memory, transposed so that a step reads
// one float4 of frames and one of states.
__global__ void __launch_bounds__(256) window_backpointers_kernel(
    const float* __restrict__ t1m1,    // [N, W, S]
    const float* __restrict__ logB,    // [S, S]
    const int* __restrict__ lengths,   // [N]
    int* __restrict__ bp,              // [N, W, Sp], rows 1 <= t < len
    int W, int S, int Sp) {
  __shared__ __align__(16) float As[VSPL_BP_KX][VSPL_BP_FT + 4];
  __shared__ __align__(16) float Bs[VSPL_BP_KX][VSPL_BP_FS + 4];
  const int n = blockIdx.z;
  const int t0 = blockIdx.x * VSPL_BP_FT, s0 = blockIdx.y * VSPL_BP_FS;
  const int len = lengths[n];
  if (t0 >= len) return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* rows = t1m1 + static_cast<size_t>(n) * W * S;
  float best[4][4];
  int arg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      best[i][c] = -CUDART_INF_F;
      arg[i][c] = 0;
    }
  for (int x0 = 0; x0 < S; x0 += VSPL_BP_KX) {
    for (int i = threadIdx.x; i < VSPL_BP_FT * VSPL_BP_KX; i += blockDim.x) {
      const int f = i / VSPL_BP_KX, xx = i % VSPL_BP_KX, x = x0 + xx;
      const int t = t0 + f, sv = s0 + f;
      As[xx][f] = t < len && x < S ? rows[static_cast<size_t>(t) * S + x] : -CUDART_INF_F;
      Bs[xx][f] = sv < S && x < S ? __ldg(logB + static_cast<size_t>(sv) * S + x) : 0.0f;
    }
    __syncthreads();
    const int kx = min(VSPL_BP_KX, S - x0);
    for (int xx = 0; xx < kx; ++xx) {
      const float4 a = *reinterpret_cast<const float4*>(&As[xx][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[xx][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = av[i] + bv[c];
          // strict: on equal values the lower source, met first, stays
          if (v > best[i][c]) {
            best[i][c] = v;
            arg[i][c] = x0 + xx;
          }
        }
    }
    __syncthreads();
  }
  const int sc = s0 + tx * 4;
  if (sc >= Sp) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= 1 && t < len)
      *reinterpret_cast<int4*>(bp + (static_cast<size_t>(n) * W + t) * Sp + sc) =
          make_int4(arg[i][0], arg[i][1], arg[i][2], arg[i][3]);
  }
}

// K8: N windows of W rows, each chased from its start state at frame len - 1;
// bp: scratch [N, W, Sp] int32, Sp = S rounded up to a multiple of 4.
extern "C" int vspl_window_backtrace(const float* t1m1, const float* logB,
                                     const int* start_states, const int* lengths,
                                     int* states, int* bp, int N, int W, int S,
                                     void* stream) {
  const int Sp = (S + 3) / 4 * 4;
  const size_t chunk_bytes = static_cast<size_t>(VSPL_CHASE_ROWS) * Sp * sizeof(int);
  if (N <= 0 || W <= 0 || S <= 0 || VSPL_CHASE_RING_BYTES / chunk_bytes < 2)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + VSPL_BP_FT - 1) / VSPL_BP_FT, (S + VSPL_BP_FS - 1) / VSPL_BP_FS, N);
  window_backpointers_kernel<<<grid, 256, 0, st>>>(t1m1, logB, lengths, bp, W, S, Sp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return static_cast<int>(vspl_launch_chase(static_cast<const int*>(bp), start_states, lengths,
                                            states, N, W, Sp, st));
}
