// Shared helpers of the Viterbi decode kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define VSPL_FULL_MASK 0xffffffffu
#define VSPL_MAX_WARPS 32
// Row values a backtrace lane handles: S <= 32 * VSPL_ROW_REGS.
#define VSPL_ROW_REGS 32
// t1m1 rows a backtrace keeps in flight in its shared-memory ring.
#define VSPL_RING 16

// An unsigned key that orders as the float does (no NaN): equal floats get
// equal keys, -0 and +0 included.
__device__ __forceinline__ unsigned vspl_order_key(float v) {
  const unsigned u = __float_as_uint(v);
  if (v == 0.0f) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key (a zero comes back as +0).
__device__ __forceinline__ float vspl_key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Maximum across a warp in one warp reduction (redux.sync); every lane
// returns it.
__device__ __forceinline__ float vspl_warp_max(float v) {
  return vspl_key_value(__reduce_max_sync(VSPL_FULL_MASK, vspl_order_key(v)));
}

// First-max argmax across a warp, given each lane's own first maximum
// (v at index i): the larger value wins, and on equal values the LOWER
// index wins (np.argmax semantics). Two warp reductions (redux.sync): the
// largest key, then the least index among the lanes that hold it. Every
// lane returns the same index.
__device__ __forceinline__ int vspl_warp_argmax(float v, int i) {
  const unsigned key = vspl_order_key(v);
  const unsigned top = __reduce_max_sync(VSPL_FULL_MASK, key);
  return static_cast<int>(__reduce_min_sync(
      VSPL_FULL_MASK, key == top ? static_cast<unsigned>(i) : 0xffffffffu));
}

// Launches kernel<kRegs> with the fewest row values per lane that cover S
// (S <= 32 * kRegs): no unrolled step of a backtrace runs past the row.
#define VSPL_DISPATCH_ROW_REGS(S, LAUNCH) \
  ((S) <= 32 * 12 ? LAUNCH(12) : (S) <= 32 * 24 ? LAUNCH(24) : LAUNCH(VSPL_ROW_REGS))

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void vspl_copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void vspl_commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Starts an asynchronous copy of this lane's share (x = lane + 32 k) of
// one [S] row from device memory into shared memory (when `active`), and
// commits it as one group — an empty group when not active, so that every
// step commits exactly one. cp.async.wait_group makes a lane's own copies
// visible to it; a lane that reads elements another lane copied needs a
// __syncwarp() after the wait as well.
__device__ __forceinline__ void vspl_stage_row(float* dst, const float* src,
                                               int lane, int S, bool active) {
  if (active)
    for (int x = lane; x < S; x += 32) vspl_copy_async(dst + x, src + x);
  vspl_commit_copies();
}

// Starts an asynchronous copy of one float (when `active`) and commits it
// as one group, empty when not active. The thread that reads it back after
// the wait needs no barrier.
__device__ __forceinline__ void vspl_stage_one(float* dst, const float* src, bool active) {
  if (active) vspl_copy_async(dst, src);
  vspl_commit_copies();
}

// Waits until at most VSPL_RING - 1 of this lane's row copies are pending,
// i.e. until the oldest staged row has landed.
__device__ __forceinline__ void vspl_wait_oldest_row() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(VSPL_RING - 1) : "memory");
}

// Waits for every pending row copy of this lane (before the block exits).
__device__ __forceinline__ void vspl_wait_all_rows() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory of a backtrace block: the ring of t1m1 rows.
inline size_t vspl_ring_bytes(int S) {
  return static_cast<size_t>(VSPL_RING) * S * sizeof(float);
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (sm_90), and the chase over backpointer rows that
// K8 (csrc/viterbi_window.cu) and K2 (csrc/viterbi_banded.cu) share.
// ---------------------------------------------------------------------------

// bp rows a bulk copy of the chase brings.
#define VSPL_CHASE_ROWS 16
// Shared memory the chase's ring may take.
#define VSPL_CHASE_RING_BYTES (200 * 1024)

__device__ __forceinline__ unsigned vspl_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void vspl_mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` more of transactions in this phase.
__device__ __forceinline__ void vspl_mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One arrival, releasing this thread's earlier writes at CTA scope.
__device__ __forceinline__ void vspl_mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed; acquire at cluster
// scope (kCluster, so that the stores other blocks made into this block are
// visible) or at CTA scope. A wait that outlasts 2^28 tries (minutes) traps,
// so that a broken invariant fails the launch instead of hanging the card.
template <bool kCluster = true>
__device__ __forceinline__ void vspl_mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    if constexpr (kCluster)
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// The address of the same shared-memory location in cluster block `rank`.
__device__ __forceinline__ unsigned vspl_map_rank(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(vspl_smem_addr(p)), "r"(rank));
  return out;
}

// Stores v at `dst` in a cluster block's shared memory and completes 4 bytes
// of the transaction count of that block's mbarrier `bar`.
__device__ __forceinline__ void vspl_store_remote(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// One bulk copy (cp.async.bulk) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device memory into this block's shared memory,
// completing its bytes on the mbarrier `bar`.
__device__ __forceinline__ void vspl_bulk_copy(void* dst, const void* src, unsigned bytes,
                                               unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(vspl_smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The chase: one thread per window (or track) walks s_{t-1} = bp[t][s_t] from
// its start state at frame len - 1. The bp rows do not depend on the state,
// so they arrive ahead: chunk c holds rows [c R, c R + R) (R =
// VSPL_CHASE_ROWS), `stages` chunks are in flight in a shared-memory ring,
// each one bulk copy on its own mbarrier, and a chunk's stage is refilled
// with chunk c - stages as soon as its last row has been read. A step is one
// shared-memory load. Rows of Sp entries of type BP, Sp * sizeof(BP) a
// multiple of 16.
template <typename BP>
__global__ void __launch_bounds__(32) vspl_chase_kernel(
    const BP* __restrict__ bp,             // [N, W, Sp]
    const int* __restrict__ start_states,  // [N]
    const int* __restrict__ lengths,       // [N]
    int* __restrict__ states,              // [N, W]
    int W, int Sp, int stages) {
  extern __shared__ __align__(16) unsigned long long chase_smem[];
  if (threadIdx.x != 0) return;
  constexpr int R = VSPL_CHASE_ROWS;
  unsigned long long* bar = chase_smem;                                    // [stages]
  BP* ring = reinterpret_cast<BP*>(chase_smem + 2 * ((stages + 1) / 2));  // [stages][R][Sp]
  const int n = blockIdx.x;
  const int len = lengths[n];
  int s = start_states[n];
  int* out = states + static_cast<size_t>(n) * W;
  out[len - 1] = s;
  if (len == 1) return;
  const BP* src = bp + static_cast<size_t>(n) * W * Sp;
  for (int i = 0; i < stages; ++i) vspl_mbar_init(vspl_smem_addr(&bar[i]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  auto fetch = [&](int c) {
    const int stage = c % stages;
    const unsigned bytes =
        static_cast<unsigned>(min(R, len - c * R) * Sp) * static_cast<unsigned>(sizeof(BP));
    const unsigned b = vspl_smem_addr(&bar[stage]);
    vspl_mbar_expect(b, bytes);
    vspl_bulk_copy(ring + static_cast<size_t>(stage) * R * Sp,
                   src + static_cast<size_t>(c) * R * Sp, bytes, b);
  };
  const int last = (len - 1) / R;
  for (int c = last; c >= 0 && c > last - stages; --c) fetch(c);
  for (int c = last; c >= 0; --c) {
    const int stage = c % stages;
    vspl_mbar_wait(vspl_smem_addr(&bar[stage]), ((last - c) / stages) & 1);
    const BP* rows = ring + static_cast<size_t>(stage) * R * Sp;
    const int hi = min(R - 1, len - 1 - c * R), lo = c == 0 ? 1 : 0;
    for (int r = hi; r >= lo; --r) {
      s = rows[r * Sp + s];
      out[c * R + r - 1] = s;  // also: the load has completed before the refill
    }
    if (c >= stages) fetch(c - stages);
  }
}

// Launches the chase over N windows of W bp rows of Sp entries: as many
// 16-row stages as fit VSPL_CHASE_RING_BYTES, at most 8 (at least 2).
template <typename BP>
inline cudaError_t vspl_launch_chase(const BP* bp, const int* start_states, const int* lengths,
                                     int* states, int N, int W, int Sp, cudaStream_t stream) {
  const size_t chunk_bytes = static_cast<size_t>(VSPL_CHASE_ROWS) * Sp * sizeof(BP);
  const int stages =
      static_cast<int>(min(static_cast<size_t>(8), VSPL_CHASE_RING_BYTES / chunk_bytes));
  if (N <= 0 || W <= 0 || stages < 2 || (Sp * sizeof(BP)) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = 8 * 2 * ((stages + 1) / 2) + stages * chunk_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      vspl_chase_kernel<BP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  vspl_chase_kernel<BP><<<N, 32, smem, stream>>>(bp, start_states, lengths, states, W, Sp, stages);
  return cudaGetLastError();
}
