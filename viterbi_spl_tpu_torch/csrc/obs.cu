// K5 and K6: the fused shaun and softmax observation models for Hopper
// (sm_90a): raw logits [N, T, n_bins] in, log observations [N, T, S] out.
//
// K5 replaces viterbi_spl_tpu/hmm/obs_pallas.py::_make_obs_kernel (body
// shaun_log_obs_block; pallas_call at obs_pallas.py:320). K6 replaces
// obs_pallas.py::_make_softmax_obs_kernel (body softmax_log_obs_block;
// pallas_call at :239). The per-frame arithmetic is obs_common.cuh's
// vspl_obs_frame, the same code K9 runs inside the banded forward, so the
// bits are K9's and the earlier K5/K6's.
//
// What bounds them on this card: each frame's logits are read once and its
// log observations written once, (n_bins + S) * 4 bytes, against about
// 2 spw + 1 operations per bin (the window maxima and the peak test) and a
// few per peak (the exp, the sum, the output), so device memory bounds them
// (3.35 TB/s). The earlier kernel (one warp a frame, 64 warps an SM, each
// lane gathering its frame's reflect-padded logits through np.pad's index
// map from device memory) spent about half of every frame in that gather
// (scripts/gpu_banded_probe.py --parts obsparts: ~14,000 of ~25,000 SM
// cycles a frame per warp at 361 states), yet hiding the gather alone
// (each warp gathering its next frame by cp.async while it computes one)
// moved nothing: with 64 warps an SM the frame's arithmetic, its window
// maxima above all, bounds it. So the frame reads half the window values
// it did (obs_common.cuh) and the logits arrive by bulk copy: a persistent
// grid of one or two blocks an SM, each a producer warp and C consumer
// warps over a ring of R tiles of F whole frames (F * n_bins contiguous
// floats) on full/empty mbarriers. One producer thread copies the tile's
// 16-byte aligned interior with one cp.async.bulk and its unaligned head
// and tail (at most three floats each: rows of 361 or 721 floats, a sliced
// input) with 4-byte cp.async tracked by the same mbarrier. A consumer warp
// takes every C-th frame of its block's tiles, builds the frame's
// reflect-padded row from the tile in shared memory (no device-memory
// gather), releases the frame's share of the tile, and computes the frame.
// The layout (blocks an SM, C, R) is the host's
// (hmm/obs_fused.py::obs_layout).

#include <cstdint>

#include "obs_common.cuh"

extern "C" const char* vspl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Frames of one tile of the ring.
#define VSPL_OBS_TILE 8
// Consumer warps a block may have (with the producer, 512 threads: up to
// 128 registers a thread, no spills).
#define VSPL_OBS_MAX_CONSUMERS 15

// Floats of one ring stage: a tile and up to three floats of alignment pad,
// rounded up so that every stage starts 16-byte aligned.
__host__ __device__ inline int vspl_obs_stage_floats(int n_bins) {
  return (VSPL_OBS_TILE * n_bins + 3 + 3) / 4 * 4;
}

// Dynamic shared memory of a block with C consumer warps and R stages.
__host__ __device__ inline size_t vspl_obs_smem(int n_bins, int spw, int C, int R) {
  const size_t n_stage = n_bins + 2 * spw;
  return 16 * static_cast<size_t>(R)                                    // full, empty
         + 4 * (static_cast<size_t>(R) * vspl_obs_stage_floats(n_bins)  // ring
                + n_stage + n_bins                                       // idx, log prior
                + static_cast<size_t>(C) * n_stage);                     // padded rows
}

// Block b of the grid owns tiles b, b + G, ... (G = gridDim.x); its i-th is
// in stage i % R. Warp 0 lane 0 produces; warps 1..C consume: warp w takes
// the block's frames q = w - 1, w - 1 + C, ... in the order of its tiles
// (tile i = q / F). full[s]: two arrivals (the bulk copy's expect_tx and the
// 4-byte copies' arrive) and the bulk bytes; empty[s]: one arrival per
// frame of the tile. A consumer's next frame lies at most (F - 1 + C) / F
// tiles ahead, and the entry requires R at least that: a parity wait then
// never meets a stage two phases behind the tile it wants.
template <int kModel>
__global__ void __launch_bounds__(VSPL_OBS_MAX_CONSUMERS * 32 + 32)
    log_obs_kernel(VsplObsArgs a, float* __restrict__ out, int n_frames, int R) {
  extern __shared__ __align__(16) unsigned long long obs_smem[];
  constexpr int F = VSPL_OBS_TILE;
  const int n_bins = a.n_bins, S = n_bins + 1, n_stage = n_bins + 2 * a.spw;
  const int C = blockDim.x / 32 - 1;
  const int stage_floats = vspl_obs_stage_floats(n_bins);
  unsigned long long* full = obs_smem;
  unsigned long long* empty = obs_smem + R;
  float* ring = reinterpret_cast<float*>(obs_smem + 2 * R);  // [R][stage_floats]
  int* idx_s = reinterpret_cast<int*>(ring + static_cast<size_t>(R) * stage_floats);
  float* prior_s = reinterpret_cast<float*>(idx_s + n_stage);
  float* rows = prior_s + n_bins;  // [C][n_stage]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (n_frames + F - 1) / F;
  const int G = gridDim.x, bx = blockIdx.x;
  const int my_tiles = bx < n_tiles ? (n_tiles - 1 - bx) / G + 1 : 0;
  // the first frame of the block's i-th tile, and the floats before the
  // tile's first 16-byte boundary (the producer's and the consumers' rule)
  auto first = [&](int i) { return static_cast<size_t>(bx + i * G) * F; };
  auto head_of = [&](size_t f0) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(a.logits + f0 * n_bins);
    return static_cast<int>((16 - addr % 16) % 16) / 4;
  };
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  if (kModel == VSPL_OBS_SOFTMAX)
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) prior_s[i] = a.log_prior[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      vspl_mbar_init(vspl_smem_addr(&full[s]), 2);
      vspl_mbar_init(vspl_smem_addr(&empty[s]), F);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane != 0) return;
    for (int i = 0; i < my_tiles; ++i) {
      const int s = i % R;
      if (i >= R) vspl_mbar_wait<false>(vspl_smem_addr(&empty[s]), (i / R - 1) & 1);
      const size_t f0 = first(i);
      const int count = min(F, n_frames - static_cast<int>(f0)) * n_bins;
      const float* src = a.logits + f0 * n_bins;
      const int head = head_of(f0);
      const int pad = (4 - head) % 4;  // element e of the tile at stage[pad + e]
      const int body = head < count ? (count - head) / 4 * 4 : 0;  // floats in 16 B units
      float* dst = ring + static_cast<size_t>(s) * stage_floats + pad;
      const unsigned bar = vspl_smem_addr(&full[s]);
      vspl_mbar_expect(bar, 4u * body);
      if (body > 0) vspl_bulk_copy(dst + head, src + head, 4u * body, bar);
      // the head and tail by 4-byte cp.async, which the arrive below tracks
      for (int e = 0; e < min(head, count); ++e) vspl_copy_async(dst + e, src + e);
      for (int e = head + body; e < count; ++e) vspl_copy_async(dst + e, src + e);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  VsplObsArgs b = a;
  b.log_prior = prior_s;
  float* x_s = rows + static_cast<size_t>(warp - 1) * n_stage;
  const int last_tile_frames =
      my_tiles == 0 ? 0 : min(F, n_frames - static_cast<int>(first(my_tiles - 1)));
  const int my_frames = my_tiles == 0 ? 0 : (my_tiles - 1) * F + last_tile_frames;
  for (int q = warp - 1; q < my_frames; q += C) {
    const int i = q / F, s = i % R;
    const size_t f0 = first(i);
    const float* tile =
        ring + static_cast<size_t>(s) * stage_floats + (4 - head_of(f0)) % 4 + (q % F) * n_bins;
    vspl_mbar_wait<false>(vspl_smem_addr(&full[s]), (i / R) & 1);
    for (int j = lane; j < n_stage; j += 32) x_s[j] = tile[idx_s[j]];
    __syncwarp();
    if (lane == 0) vspl_mbar_arrive(vspl_smem_addr(&empty[s]));  // this frame's share is read
    vspl_obs_frame<kModel>(x_s, out + (f0 + q % F) * S, b, lane);
    __syncwarp();  // every lane has read the row before the next frame lands
  }
}

template <int kModel>
static int launch_log_obs(const VsplObsArgs& a, float* out, int n_frames, int blocks_per_sm,
                          int C, int R, void* stream) {
  if (a.n_bins < 2 || a.n_bins > VSPL_OBS_MAX_BINS || a.spw < 1 || a.spw >= a.n_bins ||
      n_frames <= 0 || C < 1 || C > VSPL_OBS_MAX_CONSUMERS ||
      R < (VSPL_OBS_TILE - 1 + C) / VSPL_OBS_TILE || blocks_per_sm < 1)
    return cudaErrorInvalidValue;
  const size_t smem = vspl_obs_smem(a.n_bins, a.spw, C, R);
  cudaError_t e = cudaFuncSetAttribute(
      log_obs_kernel<kModel>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (static_cast<long long>(n_frames) + VSPL_OBS_TILE - 1) / VSPL_OBS_TILE;
  const long long most = static_cast<long long>(blocks_per_sm) * sms;
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  log_obs_kernel<kModel><<<blocks, (C + 1) * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, n_frames, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vspl_shaun_log_obs(const float* logits, const int* idx, float* out,
                                  int n_frames, int n_bins, int spw, float threshold,
                                  float offset, float scale, float log_tiny, int blocks_per_sm,
                                  int C, int R, void* stream) {
  const VsplObsArgs a{logits, idx, nullptr, threshold, offset, scale, log_tiny, n_bins, spw};
  return launch_log_obs<VSPL_OBS_SHAUN>(a, out, n_frames, blocks_per_sm, C, R, stream);
}

extern "C" int vspl_softmax_log_obs(const float* logits, const int* idx,
                                    const float* log_prior, float* out, int n_frames,
                                    int n_bins, int spw, float vth, float prior_uv,
                                    float log_tiny, int blocks_per_sm, int C, int R,
                                    void* stream) {
  const VsplObsArgs a{logits, idx, log_prior, vth, prior_uv, 0.0f, log_tiny, n_bins, spw};
  return launch_log_obs<VSPL_OBS_SOFTMAX>(a, out, n_frames, blocks_per_sm, C, R, stream);
}
