"""Measurements behind the dense batched forward K3
(viterbi_spl_tpu_torch/csrc/viterbi_dense.cu) on the GPU.

1. clusters: how many of K3's 8-block clusters (its cluster kernel, one
   cluster per track) and of K7's clusters (csrc/viterbi_window.cu: 8 blocks
   up to 384 states, 16 above) the card holds at once
   (cudaOccupancyMaxActiveClusters), at 361 and 722 states.
2. K3 by its cluster kernel against K7's kernel with reset rows 0 (the same
   DP: K3's plain version is K7's with reset row 0) at G = 1-4 tracks a
   cluster, and by its rules' choice (k3_route, k3_tracks_per_cluster), in
   turns (each in order, then in reverse) on the same inputs, at: imm 722,
   N=16, T=4096; the main path's imm tracks (N=4, lengths 1500, 700, 1100,
   500); random 361, N=16, T=4096; and the streaming pool's dense push (64
   streams x 33 rows: the carry and 32 frames) at both state counts; and
   the reproduction drill's imm shapes (cli/repro_drill.py runs imm's
   `eval --debug --original`: the debug NMF's 146 states, one batch of
   the two 24 s mdb_test tracks and one of two 8 s tracks a external
   corpus). Both routes' t1_last and t1m1 must be equal below each
   length, bit for bit. Each reading also in us a frame and track.

3. k4clock: K4's chain (9cb2ea1's kernel: one warp a track, each step
   the state-chosen logB row from L2 and a first-max warp argmax), copied
   into the probe with clock64 between the parts of each step of track 0
   (ring wait, logB row load until its values are in registers,
   compare/select, warp argmax, the state's store and the next row's
   cp.async issue), at imm 722 and random 361, N=16, T=4096; mean SM
   cycles a step.
4. k4pass: K8's backpointer pass + chase (viterbi_dense.window_backtrace)
   on K4's own inputs, taken as N windows, against K4 (dense_backtrace) in
   turns, states equal, at imm 722 N=16 T=4096, random 361 N=16 T=4096,
   imm's 4 main-path tracks, one track of 4,096 frames at both, and a
   64-stream push of 33 rows at both; with the pass's int32 scratch bytes.
   (Both take log_B from the host, so both time its upload.)

5. k4seg: K4 (the chase in segments) in turns by segment length and
   warm-up at k4pass's shapes: the plain chain (one segment a track), the
   rule (k4_segment_length, K4_WARMUP), the rule's segments at warm-ups 0,
   8, 16 and 64, and the segments shortest lengths of 16, 32, 128 and 256
   frames would give; every variant's states equal to the chain's, with the
   frames its seams re-chased (the data-dependent part of its work).
6. spills: ptxas -v's registers, stack frame and spill bytes for each
   instantiation of K7's kernel (window_forward_kernel<kVec, kG>: kVec
   2, 6, 12 by the state count, kG = 1-4 tracks a cluster), read from the
   build log of csrc/viterbi_window.cu.

    python3 scripts/gpu_dense_probe.py [--parts clusters,forward,k4clock,k4pass,k4seg,spills]

Prints the card's name and power limit, then one JSON line per reading.
K3's cluster count and the clocked chain come from a copy of
csrc/viterbi_dense.cu with probe entries appended, built here with the
port's nvcc flags, K7's count from viterbi_dense.window_max_clusters; the
timings call the port's wrappers. It is a measurement, not a decoder.
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
from viterbi_spl_tpu_torch.hmm import viterbi_dense as VD  # noqa: E402
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params  # noqa: E402

# the cluster kernel's resident clusters at S states (its launch's config)
DENSE_ENTRY = r"""
extern "C" int probe_dense_clusters(int S, int* out) {
  const int chunk = (S + VSPL_DENSE_CLUSTER - 1) / VSPL_DENSE_CLUSTER;
  const int tx_n = ((chunk + 31) / 32) * 32;
  const int threads = tx_n * (1024 / tx_n);
  const size_t smem = (2 * S + threads) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dense_forward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(VSPL_DENSE_CLUSTER * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, dense_forward_kernel, &cfg));
}

// 9cb2ea1's K4 chain (one warp a track, a VSPL_RING-row cp.async ring of
// t1m1 rows), with clock64 between the parts of each step; track 0's lane
// 0 writes the mean cycles a step of each part to clk[0..4] and of the
// whole step to clk[5]. The row's values are consumed (a max over them)
// before the clock that ends the load part.
template <int kRegs>
__global__ void __launch_bounds__(32) k4_clock_kernel(
    const float* __restrict__ t1m1, const float* __restrict__ logB,
    const int* __restrict__ last_states, const int* __restrict__ lengths,
    int* __restrict__ states, int T, int S, double* clk) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x;
  const int track = blockIdx.x;
  const int len = lengths[track];
  const float* rows = t1m1 + static_cast<size_t>(track) * T * S;
  int* out = states + static_cast<size_t>(track) * T;
  int s = last_states[track];
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < VSPL_RING; ++i) {
    const int r = len - 1 - i;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
  }
  for (int t = len - 1;; --t) {
    const long long c0 = clock64();
    if (lane == 0) out[t] = s;
    if (t == 0) break;
    vspl_wait_oldest_row();
    const long long c1 = clock64();
    const float* cur = ring + (t % VSPL_RING) * S;
    const float* brow = logB + static_cast<size_t>(s) * S;
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
    float row[kRegs];
#pragma unroll
    for (int k = 0; k < kRegs; ++k) row[k] = __ldg(brow + min(lane + 32 * k, S - 1));
    float chk = row[0];
#pragma unroll
    for (int k = 1; k < kRegs; ++k) chk = fmaxf(chk, row[k]);
    asm volatile("" : "+f"(chk));
    const long long c2 = clock64();
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const int x = lane + 32 * k;
      const float c = x < S ? cur[min(x, S - 1)] + row[k] : -CUDART_INF_F;
      if (c > best) {
        best = c;
        best_i = x;
      }
    }
    asm volatile("" : "+f"(best), "+r"(best_i));
    const long long c3 = clock64();
    s = vspl_warp_argmax(best, best_i);
    asm volatile("" : "+r"(s));
    const long long c4 = clock64();
    const int r = t - VSPL_RING;
    vspl_stage_row(ring + (r >= 1 ? r % VSPL_RING : 0) * S,
                   rows + static_cast<size_t>(max(r, 0)) * S, lane, S, r >= 1);
    const long long c5 = clock64();
    acc[0] += c1 - c0;
    acc[1] += c2 - c1;
    acc[2] += c3 - c2;
    acc[3] += c4 - c3;
    acc[4] += c5 - c4;
  }
  vspl_wait_all_rows();
  if (track == 0 && lane == 0 && len > 1) {
    long long total = 0;
    for (int i = 0; i < 5; ++i) {
      clk[i] = static_cast<double>(acc[i]) / (len - 1);
      total += acc[i];
    }
    clk[5] = static_cast<double>(total) / (len - 1);
  }
}

extern "C" int probe_k4_clock(const float* t1m1, const float* logB, const int* last,
                              const int* lengths, int* states, int N, int T, int S,
                              double* clk) {
  const size_t smem = vspl_ring_bytes(S);
  auto launch = [&](auto kernel) -> int {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<N, 32, smem>>>(t1m1, logB, last, lengths, states, T, S, clk);
    return static_cast<int>(cudaGetLastError());
  };
#define VSPL_LAUNCH(R) launch(k4_clock_kernel<R>)
  return VSPL_DISPATCH_ROW_REGS(S, VSPL_LAUNCH);
#undef VSPL_LAUNCH
}
"""

def emit(obj):
    print(json.dumps(obj), flush=True)


def build_query():
    """The cluster kernel's source with its query entry, built and loaded."""
    out_dir = cuda_lib.BUILD_DIR / "dense_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "viterbi_dense.cu"
    cu.write_text((cuda_lib.CSRC / "viterbi_dense.cu").read_text() + DENSE_ENTRY)
    lib = out_dir / "libviterbi_dense.so"
    proc = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
                           "-o", str(lib), str(cu)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the query entry:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_k4_clock.argtypes = [P, P, P, P, P, I, I, I, P]
    return lib


def cuda_ms(fn, iters=5):
    """Median ms of fn() over iters launches after one warm-up, each timed
    by the CUDA events around it."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))


def dense_matrix(S: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.random((S, S)).astype(np.float32) ** 4
    A /= A.sum(axis=1, keepdims=True)
    return A, np.full(S, 1.0 / S)


def routes():
    """The forward routes to compare: (name, fn(log_B, log_pi, log_obs,
    lengths)): K3's wrapper by the cluster kernel, by K7's kernel at 1-4
    tracks a cluster, and by its rules' choice."""
    out = [("cluster", lambda B, p, o, L: VD.dense_forward(B, p, o, L, route="cluster"))]
    out += [(f"window G{g}", lambda B, p, o, L, g=g: VD.dense_forward(B, p, o, L, route="window",
                                                                       tracks=g))
            for g in (1, 2, 3, 4)]
    return out + [("rule", VD.dense_forward)]


def imm_case():
    return hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722)


def forward_rows(A, pi, lengths, dev, seed=7):
    """(log_B, log_pi, log_obs, t1_last, t1m1): K3 on uniform log
    observations in [-20, 0) made on the card."""
    S = A.shape[0]
    log_B, log_pi = prepare_log_params(A, pi)
    g = torch.Generator(device=dev).manual_seed(seed)
    log_obs = torch.rand((len(lengths), int(lengths.max()), S), generator=g,
                         device=dev).mul_(20.0).sub_(20.0)
    t1_last, t1m1 = VD.dense_forward(log_B, log_pi, log_obs, lengths)
    return log_B, log_pi, log_obs, t1_last, t1m1


def cluster_counts(query):
    for S in (361, 722):
        out = ctypes.c_int(0)
        rc = query.probe_dense_clusters(S, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"K3 cluster query at S={S}: CUDA error {rc}")
        emit({"probe": "clusters", "S": S,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count,
              "K7_cluster_blocks": VD.window_cluster_size(S), "K3_cluster_blocks": 8,
              "max_active_clusters": {"K3_cluster_kernel": out.value,
                                      "K7_kernel": VD.window_max_clusters(S)}})


def drill_imm_shapes(dev):
    """The reproduction drill's imm decodes of the original method: the
    debug NMF's matrix (146 states) and its frame counts for the two 24 s
    mdb_test tracks and for two 8 s tracks (adc04, mirex05 and mir1k alike)."""
    from viterbi_spl_tpu_torch.models.imm import IMM, IMMConfig

    imm = IMM(IMMConfig(niters=15, R=6, P=8, K=4, bins_per_note=4), device=dev)
    S = imm.transition_matrix.shape[0]
    case = (imm.transition_matrix, np.full(S, 1.0 / S))

    def frames(seconds):
        return int(imm.power_spectrogram(np.zeros(int(seconds * imm.config.fs),
                                                  np.float32)).shape[0])

    return [(f"imm {S} drill mdb_test", case, np.full(2, frames(24.0), np.int32)),
            (f"imm {S} drill external", case, np.full(2, frames(8.0), np.int32))]


def forward_timings(dev):
    imm = imm_case()
    rnd = dense_matrix(361, 2)
    shapes = [("imm 722", imm, np.full(16, 4096, np.int32)),
              ("imm 722 main path", imm, np.array([1500, 700, 1100, 500], np.int32)),
              ("random 361", rnd, np.full(16, 4096, np.int32)),
              ("imm 722 streaming push", imm, np.full(64, 33, np.int32)),
              ("random 361 streaming push", rnd, np.full(64, 33, np.int32)),
              *drill_imm_shapes(dev)]
    fwd = routes()
    for label, (A, pi), lengths in shapes:
        S = A.shape[0]
        log_B, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(7)
        log_obs = torch.rand((len(lengths), int(lengths.max()), S), generator=g,
                             device=dev).mul_(20.0).sub_(20.0)
        outs = [f(log_B, log_pi, log_obs, lengths) for _, f in fwd]
        torch.cuda.synchronize()
        for (name, _), (t1, m) in zip(fwd[1:], outs[1:]):
            same = bool(torch.equal(t1, outs[0][0])) and all(
                torch.equal(m[n, :L], outs[0][1][n, :L]) for n, L in enumerate(lengths))
            if not same:
                raise RuntimeError(f"{label}: {name} differs from {fwd[0][0]}")
        del outs
        order = [r for r, _ in fwd] + [r for r, _ in reversed(fwd)]
        ms = {r: [] for r, _ in fwd}
        table = dict(fwd)
        iters = 5 if int(lengths.sum()) > 1 << 16 else 20
        for r in order:
            ms[r].append(cuda_ms(lambda r=r: table[r](log_B, log_pi, log_obs, lengths), iters))
        emit({"probe": "dense_forward", "shape": label, "N": len(lengths),
              "rule_tracks": VD.k3_tracks_per_cluster(len(lengths), VD.window_max_clusters(S)),
              "T": int(lengths.max()), "S": S, "lengths": lengths.tolist()[:8],
              "ms": {r: float(np.mean(v)) for r, v in ms.items()}, "readings_ms": ms,
              "us_per_frame": {r: 1e3 * float(np.mean(v)) / int(lengths.max())
                               for r, v in ms.items()},
              "us_per_frame_track": {r: 1e3 * float(np.mean(v)) / int(lengths.sum())
                                     for r, v in ms.items()}})
        del log_obs
        torch.cuda.empty_cache()


K4_CLOCK_PARTS = ("ring_wait", "row_load", "compare_select", "warp_argmax", "store_and_stage")


def k4_clock(query, dev):
    """K4's chain step split by clock64 (track 0 of N=16, T=4096)."""
    P = cuda_lib.ptr
    for label, (A, pi) in (("imm 722", imm_case()), ("random 361", dense_matrix(361, 2))):
        lengths = np.full(16, 4096, np.int32)
        log_B, _, _, t1_last, t1m1 = forward_rows(A, pi, lengths, dev)
        S = A.shape[0]
        lB = torch.as_tensor(log_B, device=dev)
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        lens = torch.as_tensor(lengths, device=dev)
        states = torch.empty((16, 4096), dtype=torch.int32, device=dev)
        clk = torch.zeros(6, dtype=torch.float64, device=dev)
        for _ in range(2):  # the first run warms the caches
            rc = query.probe_k4_clock(P(t1m1), P(lB), P(last), P(lens), P(states), 16, 4096, S,
                                      P(clk))
            if rc != 0:
                raise RuntimeError(f"probe_k4_clock: CUDA error {rc}")
            torch.cuda.synchronize()
        want = VD.dense_backtrace(log_B, t1m1, last, lengths)
        if not torch.equal(states, want):
            raise RuntimeError(f"{label}: the clocked chain's states differ from K4's")
        c = clk.cpu().numpy()
        ms = cuda_ms(lambda: VD.dense_backtrace(log_B, t1m1, last, lengths), 5)
        emit({"probe": "k4_clock", "shape": label, "N": 16, "T": 4096, "S": S,
              "sm_clock_mhz": sm_clock_mhz(),
              "cycles_per_step": {k: float(v) for k, v in zip(K4_CLOCK_PARTS, c[:5])},
              "cycles_per_step_total": float(c[5]), "K4_ms": ms,
              "K4_us_per_step": 1e3 * ms / 4095})
        del t1m1
        torch.cuda.empty_cache()


def k4_cases():
    """(label, (A, pi), lengths) of K4's shapes: the full-width ones, imm's
    main-path batch, one track of 4,096 frames and a 64-stream push."""
    imm, rnd = imm_case(), dense_matrix(361, 2)
    return [("imm 722", imm, np.full(16, 4096, np.int32)),
            ("random 361", rnd, np.full(16, 4096, np.int32)),
            ("imm 722 main path", imm, np.array([1500, 700, 1100, 500], np.int32)),
            ("imm 722 one track", imm, np.full(1, 4096, np.int32)),
            ("random 361 one track", rnd, np.full(1, 4096, np.int32)),
            ("imm 722 streaming push", imm, np.full(64, 33, np.int32)),
            ("random 361 streaming push", rnd, np.full(64, 33, np.int32))]


def k4_pass(dev):
    """K8's pass + chase on K4's inputs against K4, in turns."""
    for label, (A, pi), lengths in k4_cases():
        log_B, _, _, t1_last, t1m1 = forward_rows(A, pi, lengths, dev)
        S = A.shape[0]
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        fns = {"K4": lambda: VD.dense_backtrace(log_B, t1m1, last, lengths),
               "K8 pass+chase": lambda: VD.window_backtrace(log_B, t1m1, last, lengths)}
        a, b = (f() for f in fns.values())
        if not all(torch.equal(a[n, :L], b[n, :L]) for n, L in enumerate(lengths)):
            raise RuntimeError(f"{label}: K8's pass + chase differs from K4")
        iters = 5 if int(lengths.sum()) > 1 << 15 else 20
        ms = {k: [] for k in fns}
        for k in ("K4", "K8 pass+chase", "K8 pass+chase", "K4"):
            ms[k].append(cuda_ms(fns[k], iters))
        emit({"probe": "k4_pass", "shape": label, "N": len(lengths), "T": int(lengths.max()),
              "S": S, "ms": {k: float(np.mean(v)) for k, v in ms.items()}, "readings_ms": ms,
              "pass_scratch_bytes": len(lengths) * int(lengths.max()) * (-(-S // 4) * 4) * 4})
        del t1m1
        torch.cuda.empty_cache()


def k4_variants(N, T, S):
    """{name: (segment, warmup)} of K4 to time in turns: the plain chain
    (one segment a track), the rule, the rule's segments at other warm-ups,
    and the segments other shortest lengths would give."""
    resident = VD.dense_backtrace_resident(S)
    out = {"chain": (T, 0), "rule": (None, VD.K4_WARMUP)}
    rule_L = VD.k4_segment_length(N, T, resident)
    out.update({f"L{rule_L} W{w}": (rule_L, w) for w in (0, 8, 16, 64)})
    for shortest in (16, 32, 128, 256):
        K = max(1, min(resident // N, T // shortest))
        out[f"shortest {shortest} (L{-(-T // K)}) W{VD.K4_WARMUP}"] = (-(-T // K), VD.K4_WARMUP)
    return out


def k4_segments(dev):
    """K4 by segment length and warm-up in turns (each variant in order, then
    in reverse) at K4's shapes, every variant's states equal to the chain's,
    with the frames its seams re-chased."""
    for label, (A, pi), lengths in k4_cases():
        log_B, _, _, t1_last, t1m1 = forward_rows(A, pi, lengths, dev)
        S, N, T = A.shape[0], len(lengths), int(lengths.max())
        lB = torch.as_tensor(log_B, device=dev)
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        variants = k4_variants(N, T, S)
        fix = torch.zeros(N, dtype=torch.int32, device=dev)
        want = VD.dense_backtrace(lB, t1m1, last, lengths, segment=T)
        fixed = {}
        for name, (seg, w) in variants.items():
            fix.zero_()
            got = VD.dense_backtrace(lB, t1m1, last, lengths, segment=seg, warmup=w, fixups=fix)
            if not all(torch.equal(got[n, :L], want[n, :L]) for n, L in enumerate(lengths)):
                raise RuntimeError(f"{label}: K4 {name} differs from the chain")
            fixed[name] = int(fix.sum())
        iters = 5 if int(lengths.sum()) > 1 << 15 else 20
        ms = {k: [] for k in variants}
        for name in list(variants) + list(reversed(variants)):
            seg, w = variants[name]
            ms[name].append(cuda_ms(lambda: VD.dense_backtrace(lB, t1m1, last, lengths, segment=seg,
                                                               warmup=w), iters))
        emit({"probe": "k4_segments", "shape": label, "N": N, "T": T, "S": S,
              "resident": VD.dense_backtrace_resident(S),
              "rule_segment": VD.k4_segment_length(N, T, VD.dense_backtrace_resident(S)),
              "ms": {k: float(np.mean(v)) for k, v in ms.items()}, "readings_ms": ms,
              "frames_rechased": fixed})
        del t1m1
        torch.cuda.empty_cache()


def window_spills() -> None:
    """ptxas -v's report for each window_forward_kernel<kVec, kG> in the
    build log of csrc/viterbi_window.cu (cuda_lib builds with -Xptxas -v)."""
    import re

    log = next(cuda_lib.BUILD_DIR.glob("libviterbi_window-*.log")).read_text()
    entry = re.compile(r"Compiling entry function '(_Z\d+window_forward_kernelILi(\d+)ELi(\d+)E\w*)'")
    props = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
    regs = re.compile(r"Used (\d+) registers")
    current = None
    found = {}
    for line in log.splitlines():
        m = entry.search(line)
        if m:
            current = (int(m.group(2)), int(m.group(3)))
            found[current] = {}
            continue
        if current is None:
            continue
        m = props.search(line)
        if m:
            found[current].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                                  spill_load_bytes=int(m.group(3)))
        m = regs.search(line)
        if m:
            found[current]["registers"] = int(m.group(1))
            current = None
    if not found:
        raise RuntimeError("no window_forward_kernel entry in the ptxas log")
    for (vec, g), rec in sorted(found.items()):
        emit({"probe": "spills", "kernel": f"window_forward_kernel<{vec}, {g}>",
              "states": f"{64 * {2: 0, 6: 2, 12: 6}[vec] + 1}-{64 * vec}", "tracks_a_cluster": g,
              **rec})


def sm_clock_mhz() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


PARTS = ("clusters", "forward", "k4clock", "k4pass", "k4seg", "spills")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated: clusters (resident clusters), forward (K3's routes), "
                         "k4clock (K4's chain step, clocked), k4pass (K8's pass + chase "
                         "against K4), k4seg (K4 by segment length and warm-up), spills "
                         "(ptxas's spill bytes for K7's kernel by instantiation)")
    parts = set(ap.parse_args(argv).parts.split(","))
    if not torch.cuda.is_available():
        print("gpu_dense_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cuda_lib.build()
    query = build_query()
    if "clusters" in parts:
        cluster_counts(query)
    if "forward" in parts:
        forward_timings(dev)
    if "k4clock" in parts:
        k4_clock(query, dev)
    if "k4pass" in parts:
        k4_pass(dev)
    if "k4seg" in parts:
        k4_segments(dev)
    if "spills" in parts:
        window_spills()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
