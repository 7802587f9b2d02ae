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
