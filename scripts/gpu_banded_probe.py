"""Measurements behind the banded kernels' design (K9 and K2 of
viterbi_spl_tpu_torch/csrc/viterbi_banded.cu) on the GPU:

1. clocked observation frames: one block of w warps (w = 1, 4, 8), each
   computing whole frames of the shaun or softmax model with
   obs_common.cuh's vspl_obs_frame (the per-frame function of K5, K6 and
   K9's producers) on logits staged in shared memory; lane 0 of each warp
   reads clock64 and %globaltimer around every frame. Mean SM cycles and ns
   per frame per warp, at 361 states (spw 5) and 722 (spw 16).
2. K9 at producer and ring layouts (P warps, R frames) other than its
   rule's, each launch bit-equal to K5/K6 -> K1 on the same logits, timed
   in turns with K1 alone (on K5/K6's output) and with the rule's layout:
   the CLI's batch shape (N=8, T=8000), bench.py's two serving shapes.
3. K2's two kernels apart: the backpointer pass and the chase, each timed
   alone at the headline shape (N=128, T=32768, 361 states) and at jdc 722
   (N=64, T=4096), on K1's t1m1 of uniform log observations, beside K2 by
   the route it takes there (k2_route); and variants
   of the pass, timed in turns with the shipped one (every variant that
   writes backpointers must give K2's states through the chase):
     ilp1, ilp2, ilp8  frames a thread takes at once (shipped: 4 at up to 32
                       band registers, 1 at 96)
     tile192           at most 192 targets a block (shipped: 384)
     loads_only        the rows' copy and the two row argmaxes, no in-band
                       candidates and no stores
4. K2's routes (banded_backtrace's route "pass" and "chain") in turns (pass,
   chain, chain, pass) over tracks x frames at 361 and 722 states, on K1's
   t1m1 of uniform log observations; the states of both routes must be
   equal. The data behind k2_takes_pass's constants.
5. K2's routes against the voiced share of the decoded paths (the chain
   skips its in-band scan at an unvoiced state): 128 tracks at 361 states
   and 32 at 722, 8192 frames, uniform log observations with the unvoiced
   lane raised by 30 in a random share of the frames; per share, the
   voiced share of the states and of the last states, and both routes'
   times in turns.

    python3 scripts/gpu_banded_probe.py [--parts obs,k9,k2,routes,voicing]

Prints one JSON line per reading, and the card's name and power limit. Each
variant's source is csrc/viterbi_banded.cu, patched, with entries for the
clocked frames and for each of K2's kernels appended; it is built here with
nvcc and the port's flags. It is a measurement, not a decoder.
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
from viterbi_spl_tpu_torch.hmm import obs_fused as OF  # noqa: E402
from viterbi_spl_tpu_torch.hmm import params as hmm_params  # noqa: E402
from viterbi_spl_tpu_torch.hmm import viterbi_banded as VB  # noqa: E402
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params  # noqa: E402

ILP = "  static constexpr int kIlp = kBand > VSPL_BAND_REGS ? 1 : 4;"
VARIANTS = {
    "shipped": [],
    "ilp1": [(ILP, "  static constexpr int kIlp = 1;")],
    "ilp2": [(ILP, "  static constexpr int kIlp = 2;")],
    "ilp8": [(ILP, "  static constexpr int kIlp = kBand > VSPL_BAND_REGS ? 4 : 8;")],
    "tile192": [("  static constexpr int kThreads = kBand > VSPL_BAND_REGS ? 256 : 384;",
                 "  static constexpr int kThreads = kBand > VSPL_BAND_REGS ? 256 : 192;")],
    "loads_only": [("  if (tid >= tile || s >= S) return;\n", "  return;\n")],
}
BANDED = cuda_lib.CSRC / "viterbi_banded.cu"

ENTRIES = r"""

__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One block: warp w computes frames w, w + warps, ... < frames; lane 0
// adds each frame's cycles and ns to out[2 w], out[2 w + 1].
template <int kModel>
__global__ void obs_clock_kernel(VsplObsArgs a, int frames, long long* out) {
  extern __shared__ float sm[];
  const int n_stage = a.n_bins + 2 * a.spw;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx_s = reinterpret_cast<int*>(sm);
  float* prior_s = sm + n_stage;
  float* stage = prior_s + a.n_bins + warp * (n_stage + a.n_bins + 1);
  float* obs = stage + n_stage;
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) idx_s[i] = a.idx[i];
  for (int i = threadIdx.x; i < a.n_bins; i += blockDim.x) prior_s[i] = a.log_prior[i];
  __syncthreads();
  VsplObsArgs b = a;
  b.log_prior = prior_s;
  long long cyc = 0, ns = 0;
  for (int f = warp; f < frames; f += warps) {
    vspl_stage_logits(stage, a.logits + static_cast<size_t>(f) * a.n_bins, idx_s, n_stage, lane);
    __syncwarp();
    const long long c0 = clock64();
    const unsigned long long t0 = probe_ns();
    vspl_obs_frame<kModel>(stage, obs, b, lane);
    __syncwarp();
    const unsigned long long t1 = probe_ns();
    const long long c1 = clock64();
    cyc += c1 - c0;
    ns += static_cast<long long>(t1 - t0);
  }
  if (lane == 0) {
    out[2 * warp] = cyc;
    out[2 * warp + 1] = ns;
  }
}

extern "C" int probe_obs_clock(const float* logits, const int* idx, const float* log_prior,
                               int model, int n_bins, int spw, float p0, float p1, float p2,
                               float log_tiny, int warps, int frames, long long* out) {
  const VsplObsArgs a{logits, idx, log_prior, p0, p1, p2, log_tiny, n_bins, spw};
  const int n_stage = n_bins + 2 * spw;
  const size_t smem = (n_stage + n_bins + warps * (n_stage + n_bins + 1)) * sizeof(float);
  auto kernel = model == VSPL_OBS_SHAUN ? obs_clock_kernel<VSPL_OBS_SHAUN>
                                        : obs_clock_kernel<VSPL_OBS_SOFTMAX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<1, 32 * warps, smem>>>(a, frames, out);
  return static_cast<int>(cudaGetLastError());
}

// K2's pass alone (as vspl_banded_backtrace launches it).
extern "C" int probe_k2_pass(const float* t1m1, const float* bv, const int* cls,
                             const int* lengths, short* bp, int N, int T, int S, int d_max,
                             float log_tiny, float log_c_uv, float log_c_vu, float log_c_uu) {
  return static_cast<int>(launch_pass(t1m1, bv, cls, lengths, bp, N, T, S, (S + 7) / 8 * 8,
                                      d_max, log_tiny, log_c_uv, log_c_vu, log_c_uu, 0));
}

// K2's chase alone.
extern "C" int probe_k2_chase(const short* bp, const int* last, const int* lengths, int* states,
                              int N, int T, int S) {
  return static_cast<int>(
      vspl_launch_chase<short>(bp, last, lengths, states, N, T, (S + 7) / 8 * 8, 0));
}
"""

P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(names) -> dict:
    """{variant: loaded library}, one nvcc per variant, all started together."""
    out_dir = cuda_lib.BUILD_DIR / "banded_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = BANDED.read_text()
    procs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the shipped source no longer has {old[:60]!r}")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src + ENTRIES)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        emit({"probe": "build", "variant": name,
              "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})
        lib = ctypes.CDLL(str(lib))
        lib.probe_obs_clock.argtypes = [P_, P_, P_, I_, I_, I_, F_, F_, F_, F_, I_, I_, P_]
        lib.probe_k2_pass.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_]
        lib.probe_k2_chase.argtypes = [P_, P_, P_, P_, I_, I_, I_]
        libs[name] = lib
    return libs


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))


def shaped(n_bins, d_max, seed):
    rng = np.random.default_rng(seed)
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 5000)), 0, n_bins - 1)]
    stats = hmm_params.count_statistics(walk, n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]), n_bins, d_max, floor=2)
    return A, hmm_params.shape_init_probs(stats.p_steady, p_th=1e-4)


def obs_cfg(method, spw, n_bins, seed):
    pri = np.random.default_rng(seed).random(n_bins + 1).astype(np.float32) + 0.1
    return dict(method=method, spw=spw, threshold_logit=0.0, init_probs=pri / pri.sum())


def clocked_frames(lib, dev):
    P = cuda_lib.ptr
    frames = 256
    for n_bins, spw in ((360, 5), (721, 16)):
        g = torch.Generator(device=dev).manual_seed(n_bins)
        logits = torch.randn((frames, n_bins), generator=g, device=dev).sub_(2.0)
        idx = torch.as_tensor(OF.reflect_index(n_bins, spw), device=dev)
        for method in ("shaun", "softmax-scaled"):
            model, _, params, log_prior = OF.obs_params(obs_cfg(method, spw, n_bins, 1), n_bins)
            prior = torch.as_tensor(log_prior, device=dev)
            for warps in (1, 4, 8):
                out = torch.zeros(2 * warps, dtype=torch.int64, device=dev)
                for _ in range(2):  # the first run warms the caches
                    out.zero_()
                    rc = lib.probe_obs_clock(P(logits), P(idx), P(prior), model, n_bins, spw,
                                             *map(float, params[:3]), VB.LOG_TINY, warps,
                                             frames, P(out))
                    if rc != 0:
                        raise RuntimeError(f"probe_obs_clock: CUDA error {rc}")
                    torch.cuda.synchronize()
                o = out.view(warps, 2).cpu().numpy().astype(np.float64)
                emit({"probe": "obs_frame", "S": n_bins + 1, "spw": spw, "method": method,
                      "warps": warps, "frames_per_warp": frames / warps,
                      "cycles_per_frame": float(o[:, 0].sum() / frames),
                      "ns_per_frame": float(o[:, 1].sum() / frames)})


def k9_layouts(dev):
    shapes = [("CLI batch 361", 360, 14, 5, 8, 8000, [(2, 32), (4, 32), (6, 32), (8, 32),
                                                      (12, 32), (16, 32), (8, 16), (8, 48)]),
              ("tonet 361 serving", 360, 14, 5, 128, 8192, [(4, 32), (6, 32), (8, 32),
                                                             (12, 32), (16, 32)]),
              ("jdc 722 serving", 721, 40, 16, 64, 4096, [(1, 16), (2, 16), (3, 16), (4, 16),
                                                          (6, 16), (9, 16), (4, 8), (4, 32)])]
    rule = VB.k9_layout
    for label, n_bins, d_max, spw, N, T, layouts in shapes:
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        _, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(7)
        logits = torch.randn((N, T, n_bins), generator=g, device=dev).sub_(2.0)
        lengths = np.full(N, T, np.int32)
        if N == 8:
            lengths = np.linspace(2000, 8000, 8).astype(np.int32)
        for method in ("shaun", "softmax-scaled"):
            obs = obs_cfg(method, spw, n_bins, 2)
            model = OF.obs_params(obs, n_bins)[0]
            log_obs = OF.log_obs(logits, obs)
            t1_ref, m_ref = VB.banded_forward(bs, log_pi, log_obs, lengths)
            k1 = lambda: VB.banded_forward(bs, log_pi, log_obs, lengths)  # noqa: E731
            k56_k1 = lambda: VB.banded_forward(bs, log_pi, OF.log_obs(logits, obs), lengths)  # noqa: E731
            rec = {"probe": "k9_layout", "shape": label, "N": N, "T": T, "S": n_bins + 1,
                   "method": method, "rule": list(rule(n_bins + 1, model)),
                   "K1_ms_before": cuda_ms(k1), "K5K6_K1_ms": cuda_ms(k56_k1), "layouts": {}}
            for lay in [rule(n_bins + 1, model)] + layouts:
                VB.k9_layout = lambda S, m, lay=lay: lay  # noqa: E731
                t1, m = VB.banded_forward_obs(bs, log_pi, logits, lengths, obs)
                exact = bool(torch.equal(t1, t1_ref)) and all(
                    torch.equal(m[i, :L], m_ref[i, :L]) for i, L in enumerate(lengths))
                del m
                ms = cuda_ms(lambda: VB.banded_forward_obs(bs, log_pi, logits, lengths, obs))
                rec["layouts"][f"P{lay[0]} R{lay[1]}"] = {"ms": ms, "exact": exact}
                if not exact:
                    raise RuntimeError(f"K9 at {lay} differs from K5/K6 -> K1 ({label}, {method})")
            VB.k9_layout = rule
            rec["K1_ms_after"] = cuda_ms(k1)
            emit(rec)
            del log_obs, m_ref
            torch.cuda.empty_cache()
        del logits
        torch.cuda.empty_cache()


def k2_split(libs, dev):
    P = cuda_lib.ptr
    lib = libs["shipped"]
    for label, n_bins, d_max, N, T in (("tonet 361", 360, 14, 128, 32768),
                                       ("jdc 722", 721, 40, 64, 4096)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        g = torch.Generator(device=dev).manual_seed(3)
        log_obs = torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
        lengths = np.full(N, T, np.int32)
        t1, t1m1 = VB.banded_forward(bs, log_pi, log_obs, lengths)
        del log_obs
        torch.cuda.empty_cache()
        last = torch.argmax(t1, dim=1).to(torch.int32)
        bv, cls = VB._profiles(bs, dev)
        lens = torch.as_tensor(lengths, device=dev)
        bp = torch.empty((N, T, VB.bp_row_entries(S)), dtype=torch.int16, device=dev)
        states = torch.empty((N, T), dtype=torch.int32, device=dev)
        want = VB.banded_backtrace(bs, t1m1, last, lengths)

        def run_pass(lib):
            rc = lib.probe_k2_pass(P(t1m1), P(bv), P(cls), P(lens), P(bp), N, T, S, d_max,
                                   VB.LOG_TINY, bs.log_c_uv, bs.log_c_vu, bs.log_c_uu)
            if rc != 0:
                raise RuntimeError(f"probe_k2_pass: CUDA error {rc}")

        def run_chase(lib):
            rc = lib.probe_k2_chase(P(bp), P(last), P(lens), P(states), N, T, S)
            if rc != 0:
                raise RuntimeError(f"probe_k2_chase: CUDA error {rc}")

        run_pass(lib)
        ms_chase = cuda_ms(lambda: run_chase(lib))
        rec = {"probe": "k2_split", "shape": label, "N": N, "T": T, "S": S,
               "chase_ms": ms_chase, "chase_us_per_step": 1e3 * ms_chase / (T - 1),
               "K2_ms": cuda_ms(lambda: VB.banded_backtrace(bs, t1m1, last, lengths)),
               "K2_route": VB.k2_route(bs, N, T, last),
               "bp_scratch_bytes": bp.numel() * 2, "pass_ms": {}}
        for name, vlib in libs.items():
            if name == "shipped":
                continue
            shipped_a = cuda_ms(lambda: run_pass(lib))
            ms = cuda_ms(lambda: run_pass(vlib))
            shipped_b = cuda_ms(lambda: run_pass(lib))
            if name != "loads_only":
                run_chase(lib)
                if not torch.equal(states, want):
                    raise RuntimeError(f"pass variant {name} gives other states than K2 ({label})")
            rec["pass_ms"][name] = ms
            rec["pass_ms"].setdefault("shipped", []).extend([shipped_a, shipped_b])
        run_pass(lib)
        run_chase(lib)
        rec["states_equal"] = bool(torch.equal(states, want))
        emit(rec)
        if not rec["states_equal"]:
            raise RuntimeError("the probe's pass and chase disagree with K2")
        del t1m1, bp
        torch.cuda.empty_cache()


ROUTE_TRACKS = (1, 8, 16, 32, 64, 96, 128, 192, 256, 512, 1024)
ROUTE_FRAMES = (1024, 4096, 8192, 16384, 32768)
ROUTE_MAX_BYTES = 16e9  # t1m1 of one grid cell at most


def k2_routes(dev):
    for n_bins, d_max in ((360, 14), (721, 40)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        for T in ROUTE_FRAMES:
            Ns = [N for N in ROUTE_TRACKS if N * T * S * 4 <= ROUTE_MAX_BYTES]
            Nmax = Ns[-1]
            g = torch.Generator(device=dev).manual_seed(5)
            log_obs = torch.rand((Nmax, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
            t1_all, t1m1_all = VB.banded_forward(bs, log_pi, log_obs, np.full(Nmax, T, np.int32))
            del log_obs
            torch.cuda.empty_cache()
            last_all = torch.argmax(t1_all, dim=1).to(torch.int32)
            for N in Ns:
                t1m1, last, lengths = t1m1_all[:N], last_all[:N], np.full(N, T, np.int32)
                run = {r: (lambda r=r: VB.banded_backtrace(bs, t1m1, last, lengths, route=r))
                       for r in ("pass", "chain")}
                same = bool(torch.equal(run["pass"](), run["chain"]()))
                ms = {"pass": [], "chain": []}
                for r in ("pass", "chain", "chain", "pass"):
                    ms[r].append(cuda_ms(run[r], iters=3))
                rec = {"probe": "k2_routes", "S": S, "d_max": d_max, "N": N, "T": T,
                       "pass_ms": min(ms["pass"]), "chain_ms": min(ms["chain"]),
                       "pass_ps_per_item": 1e9 * min(ms["pass"]) / (N * S * (2 * d_max + 1) * T),
                       "chain_us_per_step": 1e3 * min(ms["chain"]) / T,
                       "rule_route": VB.k2_route(bs, N, T, last),
                       "bp_scratch_bytes": 2 * N * T * VB.bp_row_entries(S),
                       "states_equal": same}
                emit(rec)
                torch.cuda.empty_cache()
                if not same:
                    raise RuntimeError(f"K2's routes disagree at S={S} N={N} T={T}")
            del t1m1_all, t1_all
            torch.cuda.empty_cache()


def k2_voicing(dev):
    T = 8192
    for n_bins, d_max, N in ((360, 14, 128), (721, 40, 32)):
        A, pi = shaped(n_bins, d_max, 0 if n_bins == 360 else 1)
        bs = VB.extract_banded_structure(A)
        S = n_bins + 1
        _, log_pi = prepare_log_params(A, pi)
        lengths = np.full(N, T, np.int32)
        for share in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0):
            g = torch.Generator(device=dev).manual_seed(7)
            log_obs = torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
            raise_uv = torch.rand((N, T), generator=g, device=dev) < share
            log_obs[:, :, n_bins] += 30.0 * raise_uv
            t1, t1m1 = VB.banded_forward(bs, log_pi, log_obs, lengths)
            del log_obs
            last = torch.argmax(t1, dim=1).to(torch.int32)
            run = {r: (lambda r=r: VB.banded_backtrace(bs, t1m1, last, lengths, route=r))
                   for r in ("pass", "chain")}
            states = run["chain"]()
            same = bool(torch.equal(run["pass"](), states))
            ms = {"pass": [], "chain": []}
            for r in ("pass", "chain", "chain", "pass"):
                ms[r].append(cuda_ms(run[r], iters=3))
            emit({"probe": "k2_voicing", "S": S, "d_max": d_max, "N": N, "T": T,
                  "uv_raised_share": share,
                  "voiced_share": float((states != n_bins).float().mean()),
                  "voiced_share_last": float((last != n_bins).float().mean()),
                  "pass_ms": min(ms["pass"]), "chain_ms": min(ms["chain"]),
                  "chain_us_per_step": 1e3 * min(ms["chain"]) / T,
                  "pass_us_per_frame": 1e3 * min(ms["pass"]) / T,
                  "rule_route": VB.k2_route(bs, N, T, last),
                  "states_equal": same})
            del t1m1, t1
            torch.cuda.empty_cache()
            if not same:
                raise RuntimeError(f"K2's routes disagree at S={S}, share {share}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="obs,k9,k2,routes,voicing",
                    help="comma-separated: obs (clocked frames), k9 (layouts), k2 (split), "
                         "routes (K2's two routes), voicing (the routes by voiced share)")
    parts = set(ap.parse_args(argv).parts.split(","))
    if not torch.cuda.is_available():
        print("gpu_banded_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cuda_lib.build(["viterbi_banded", "obs"])
    libs = build(list(VARIANTS) if "k2" in parts else ["shipped"])
    if "obs" in parts:
        clocked_frames(libs["shipped"], dev)
    if "k9" in parts:
        k9_layouts(dev)
    if "k2" in parts:
        k2_split(libs, dev)
    if "routes" in parts:
        k2_routes(dev)
    if "voicing" in parts:
        k2_voicing(dev)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
