// K5 and K6: the fused shaun and softmax observation models for Hopper
// (sm_90a): raw logits [N, T, n_bins] in, log observations [N, T, S] out.
//
// K5 replaces viterbi_spl_tpu/hmm/obs_pallas.py::_make_obs_kernel (body
// shaun_log_obs_block; pallas_call at obs_pallas.py:320). K6 replaces
// obs_pallas.py::_make_softmax_obs_kernel (body softmax_log_obs_block;
// pallas_call at :239). The per-frame arithmetic is obs_common.cuh's, the
// same code K9 runs inside the banded forward.
//
// What bounds them on this card: each frame's logits are read once and its
// log observations written once, (n_bins + S) * 4 bytes, against about
// 2 spw + 1 operations per bin (the window maxima and the peak test) and a
// few per peak (the exp, the sum, the output), so device memory bounds them
// (3.35 TB/s). (The windows by shift doubling in scratch rows made K5/K6
// slower on the H100: PERF.md.) The design is one warp per
// frame: the warp gathers its frame's reflect-padded logits through the
// index map (np.pad's, staged once per block in shared memory) into its
// own shared-memory row, then tests and writes its bins; the frame's
// maximum and denominator are warp reductions. Blocks of VSPL_OBS_WARPS
// warps stride over the N * T frames, with enough warps on each SM to keep
// the loads of many frames in flight.

#include "obs_common.cuh"

#define VSPL_OBS_WARPS 8

extern "C" const char* vspl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <int kModel>
__global__ void __launch_bounds__(VSPL_OBS_WARPS * 32)
    log_obs_kernel(VsplObsArgs a, float* __restrict__ out, int n_frames) {
  extern __shared__ float smem[];
  const int n_stage = a.n_bins + 2 * a.spw;
  const int S = a.n_bins + 1;
  int* idx_s = reinterpret_cast<int*>(smem);                     // [n_stage]
  float* stage = smem + n_stage + (threadIdx.x >> 5) * n_stage;  // this warp's frame
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int f = blockIdx.x * VSPL_OBS_WARPS + (threadIdx.x >> 5); f < n_frames;
       f += gridDim.x * VSPL_OBS_WARPS) {
    vspl_stage_logits(stage, a.logits + static_cast<size_t>(f) * a.n_bins, idx_s, n_stage,
                      lane);
    __syncwarp();
    vspl_obs_frame<kModel>(stage, out + static_cast<size_t>(f) * S, a, lane);
    __syncwarp();  // every lane has read the row before the next frame lands
  }
}

template <int kModel>
static int launch_log_obs(const VsplObsArgs& a, float* out, int n_frames, void* stream) {
  if (a.n_bins < 2 || a.n_bins > VSPL_OBS_MAX_BINS || a.spw < 1 || a.spw >= a.n_bins ||
      n_frames <= 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(1 + VSPL_OBS_WARPS) * (a.n_bins + 2 * a.spw) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_obs_kernel<kModel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (static_cast<long long>(n_frames) + VSPL_OBS_WARPS - 1) / VSPL_OBS_WARPS;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  log_obs_kernel<kModel><<<blocks, VSPL_OBS_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, n_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vspl_shaun_log_obs(const float* logits, const int* idx, float* out,
                                  int n_frames, int n_bins, int spw, float threshold,
                                  float offset, float scale, float log_tiny, void* stream) {
  const VsplObsArgs a{logits, idx, nullptr, threshold, offset, scale, log_tiny, n_bins, spw};
  return launch_log_obs<VSPL_OBS_SHAUN>(a, out, n_frames, stream);
}

extern "C" int vspl_softmax_log_obs(const float* logits, const int* idx,
                                    const float* log_prior, float* out, int n_frames,
                                    int n_bins, int spw, float vth, float prior_uv,
                                    float log_tiny, void* stream) {
  const VsplObsArgs a{logits, idx, log_prior, vth, prior_uv, 0.0f, log_tiny, n_bins, spw};
  return launch_log_obs<VSPL_OBS_SOFTMAX>(a, out, n_frames, stream);
}
