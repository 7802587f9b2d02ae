"""Where a banded backtrace step's time goes on the GPU: the step designs of
the port's first K2 (one warp per track taking the argmax of each step, as
viterbi_spl_tpu_torch/csrc/viterbi_banded.cu did before K2 became a
backpointer pass and a chase) and ablations of them, one warp per track,
timed with CUDA events and counted in SM cycles (clock64 in track 0), on
tonet's shaped 361-state matrix.

    python3 scripts/gpu_backtrace_probe.py [--n 128] [--t 8192]

Variants (each a chain of T dependent argmax steps per track; all read the
t1m1 rows through K2's cp.async ring unless said otherwise):
  branchy      the first design: per source, branches pick the logB value
               and the in-band ones load class and profile behind a branch;
               five-round shuffle argmax
  clamped      every source loads its profile value at a clamped offset, no
               branch; redux argmax
  split        the design K2 shipped: all sources with their out-of-band value,
               then the in-band sources with their profile values (kept in
               shared memory); redux argmax
  split_l1     split with the profiles read through L1
  split_shfl   split with the shuffle argmax
  zero_row     split's row loads and argmax with a zero logB row
  split_direct split, with each row read from device memory when needed
  ring_only    the ring staged and waited on, values from arithmetic
  chain_only   no memory at all: values from arithmetic, argmax, store
The variants that decode (all but zero_row, ring_only and chain_only)
must give the same states; the script fails otherwise. Prints one JSON line
per variant, and the card's name and power limit. The CUDA source is built
here with nvcc and the port's flags; it is a measurement, not a decoder.
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
from viterbi_spl_tpu_torch.hmm import params as hmm_params  # noqa: E402
from viterbi_spl_tpu_torch.hmm import viterbi_banded as VB  # noqa: E402

MODES = ("branchy", "clamped", "split", "split_l1", "split_shfl", "zero_row",
         "split_direct", "ring_only", "chain_only")
DECODING = ("branchy", "clamped", "split", "split_l1", "split_shfl", "split_direct")

SOURCE = r"""
#include "viterbi_common.cuh"

enum { BRANCHY, CLAMPED, SPLIT, SPLIT_L1, SPLIT_SHFL, ZERO_ROW, SPLIT_DIRECT, RING_ONLY,
       CHAIN_ONLY };

__device__ __forceinline__ int shfl_argmax(float v, int i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(VSPL_FULL_MASK, v, off);
    const int oi = __shfl_xor_sync(VSPL_FULL_MASK, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
  return i;
}

// arithmetic stand-in for a row value: depends on x, t and s
__device__ __forceinline__ float fake(int x, int t, int s) {
  const unsigned h = (unsigned)x * 2654435761u ^ (unsigned)t * 40503u ^ (unsigned)s * 97u;
  return -(float)(h & 0xffffu);
}

template <int kMode>
__global__ void __launch_bounds__(32) probe_kernel(
    const float* __restrict__ t1m1, const float* __restrict__ bv,
    const int* __restrict__ cls, int* __restrict__ states,
    long long* __restrict__ cycles, int T, int S, int d_max, int n_classes, float log_tiny,
    float log_c_uv, float log_c_vu, float log_c_uu) {
  constexpr int kRegs = 12;  // S <= 384
  constexpr bool kRing = kMode != SPLIT_DIRECT && kMode != CHAIN_ONLY;
  extern __shared__ float ring[];
  int* prof_off = reinterpret_cast<int*>(ring + VSPL_RING * S);
  float* bv_s = reinterpret_cast<float*>(prof_off + 2 * d_max + 1);  // [n_classes][S]
  const float* prof = kMode == SPLIT_L1 ? bv : bv_s;
  const int lane = threadIdx.x;
  const int track = blockIdx.x;
  const int n = S - 1;
  const int W = 2 * d_max + 1;
  const float* rows = t1m1 + static_cast<size_t>(track) * T * S;
  int* out = states + static_cast<size_t>(track) * T;
  int s = n / 2;
  for (int i = lane; i < W; i += 32) prof_off[i] = cls[i] * S;
  for (int i = lane; i < n_classes * S; i += 32) bv_s[i] = bv[i];
  const long long c0 = clock64();
  if (kRing)
    for (int i = 0; i < VSPL_RING; ++i) {
      const int r = T - 1 - i;
      vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                     rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
    }
  __syncwarp();
  for (int t = T - 1;; --t) {
    if (lane == 0) out[t] = s;
    if (t == 0) break;
    if (kRing) {
      vspl_wait_oldest_row();
      __syncwarp();
    }
    const float* cur = kRing ? ring + (t % VSPL_RING) * S : rows + static_cast<size_t>(t) * S;
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
    if constexpr (kMode == BRANCHY) {
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int x = lane + 32 * k;
        if (x < S) {
          float r;
          if (s == n) {
            r = x < n ? log_c_vu : log_c_uu;
          } else if (x == n) {
            r = log_c_uv;
          } else {
            const int e = x - s;
            r = (e >= -d_max && e <= d_max) ? __ldg(bv + __ldg(cls + e + d_max) * S + x)
                                            : log_tiny;
          }
          const float c = cur[x] + r;
          if (c > best) { best = c; best_i = x; }
        }
      }
    } else if constexpr (kMode == CLAMPED) {
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int x = lane + 32 * k;
        const int xc = min(x, n);
        const int e = xc - s;
        const int ec = min(max(e, -d_max), d_max);
        float r = __ldg(bv + prof_off[ec + d_max] + xc);
        r = e == ec ? r : log_tiny;
        r = xc == n ? log_c_uv : r;
        r = s == n ? (xc < n ? log_c_vu : log_c_uu) : r;
        const float c = x < S ? cur[xc] + r : -CUDART_INF_F;
        if (c > best) { best = c; best_i = x; }
      }
    } else if constexpr (kMode == RING_ONLY || kMode == CHAIN_ONLY) {
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int x = lane + 32 * k;
        const float c = x < S ? fake(x, t, s) : -CUDART_INF_F;
        if (c > best) { best = c; best_i = x; }
      }
    } else {  // SPLIT, SPLIT_L1, SPLIT_SHFL, ZERO_ROW, SPLIT_DIRECT: K2's step
      const bool uv = s == n;
      const float r_voiced = kMode == ZERO_ROW ? 0.0f : uv ? log_c_vu : log_tiny;
      const float r_unvoiced = kMode == ZERO_ROW ? 0.0f : uv ? log_c_uu : log_c_uv;
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int x = lane + 32 * k;
        const int xc = min(x, n);
        const float v = kRing ? cur[xc] : __ldg(cur + xc);
        const float c = x < S ? v + (xc == n ? r_unvoiced : r_voiced) : -CUDART_INF_F;
        if (c > best) { best = c; best_i = x; }
      }
      if (!uv && kMode != ZERO_ROW) {
        for (int j = lane; j < W; j += 32) {
          const int x = s - d_max + j;
          const int xc = min(max(x, 0), n - 1);
          const float v = kRing ? cur[xc] : __ldg(cur + xc);
          const float c = x == xc ? v + prof[prof_off[j] + xc] : -CUDART_INF_F;
          if (c > best || (c == best && x < best_i)) { best = c; best_i = x; }
        }
      }
    }
    s = (kMode == BRANCHY || kMode == SPLIT_SHFL) ? shfl_argmax(best, best_i)
                                                  : vspl_warp_argmax(best, best_i);
    if (kRing) {
      const int r = t - VSPL_RING;
      vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                     rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
    }
  }
  if (kRing) vspl_wait_all_rows();
  if (track == 0 && lane == 0) cycles[0] = clock64() - c0;
}

extern "C" const char* vspl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int probe(int mode, const float* t1m1, const float* bv, const int* cls,
                     int* states, long long* cycles, int N, int T, int S, int d_max,
                     int n_classes, float log_tiny, float log_c_uv, float log_c_vu,
                     float log_c_uu, void* stream) {
  if (S > 32 * 12) return cudaErrorInvalidValue;
  const size_t smem = (VSPL_RING + n_classes) * S * sizeof(float) +
                      (2 * d_max + 1) * sizeof(int);
  auto launch = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<N, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        t1m1, bv, cls, states, cycles, T, S, d_max, n_classes, log_tiny, log_c_uv,
        log_c_vu, log_c_uu);
    return static_cast<int>(cudaGetLastError());
  };
  switch (mode) {
    case BRANCHY: return launch(probe_kernel<BRANCHY>);
    case CLAMPED: return launch(probe_kernel<CLAMPED>);
    case SPLIT: return launch(probe_kernel<SPLIT>);
    case SPLIT_L1: return launch(probe_kernel<SPLIT_L1>);
    case SPLIT_SHFL: return launch(probe_kernel<SPLIT_SHFL>);
    case ZERO_ROW: return launch(probe_kernel<ZERO_ROW>);
    case SPLIT_DIRECT: return launch(probe_kernel<SPLIT_DIRECT>);
    case RING_ONLY: return launch(probe_kernel<RING_ONLY>);
    case CHAIN_ONLY: return launch(probe_kernel<CHAIN_ONLY>);
  }
  return cudaErrorInvalidValue;
}
"""


def build() -> ctypes.CDLL:
    """Compile SOURCE with the port's nvcc flags into the port's build
    directory and bind its entry."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_lib.BUILD_DIR / "gpu_backtrace_probe.cu"
    lib = cuda_lib.BUILD_DIR / "libgpu_backtrace_probe.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.probe.argtypes = [I, P, P, P, P, P, I, I, I, I, I, F, F, F, F, P]
    so.probe.restype = I
    so.vspl_error_string.argtypes = [I]
    so.vspl_error_string.restype = ctypes.c_char_p
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--t", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gpu_backtrace_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = build()
    dev = torch.device("cuda")
    # tonet's shaped matrix from a synthetic pitch walk (as chip_smoke.py)
    n_bins, rng = 360, np.random.default_rng(0)
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 5000)), 0, n_bins - 1)]
    stats = hmm_params.count_statistics(walk, n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]), n_bins,
        hmm_params.single_side_d_max(0.01, 60), floor=2)
    bs = VB.extract_banded_structure(A)
    N, T, S, d_max = args.n, args.t, bs.S, bs.d_max
    g = torch.Generator(device=dev).manual_seed(0)
    t1m1 = torch.rand((N, T, S), generator=g, device=dev).mul_(-50.0)
    bv = torch.from_numpy(np.ascontiguousarray(bs.bv[:, :S])).to(dev)
    cls = torch.from_numpy(bs.class_of_offset()).to(dev)
    states = torch.empty((N, T), dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    P = cuda_lib.ptr
    decoded = {}
    for mode, name in enumerate(MODES):
        def run():
            rc = lib.probe(mode, P(t1m1), P(bv), P(cls), P(states), P(cycles), N, T, S,
                           d_max, bv.shape[0], VB.LOG_TINY, bs.log_c_uv, bs.log_c_vu,
                           bs.log_c_uu, stream)
            cuda_lib.check(lib, rc, name)
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / args.iters
        cyc = int(cycles.item())
        if name in DECODING:
            decoded[name] = states.clone()
        print(json.dumps({
            "variant": name, "N": N, "T": T, "S": S, "ms": ms,
            "us_per_step": 1e3 * ms / T, "cycles_per_step_track0": cyc / T,
            "track0_ghz": cyc / (ms * 1e6),
        }), flush=True)
    same = all(torch.equal(decoded[name], decoded["split"]) for name in DECODING)
    print(json.dumps({"decoding_variants_agree": same}), flush=True)
    print(smi, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
