"""Design choices of the window kernels K7/K8
(viterbi_spl_tpu_torch/csrc/viterbi_window.cu) measured on the GPU: each
variant is the shipped source with one named change, built with the port's
nvcc flags and timed with CUDA events in turns (variants in order, then in
reverse), on the shapes the single-track and time-sharded decodes give them.

    python3 scripts/gpu_window_probe.py

K7 variants:
  shipped     the source as it is
  cluster16   16-block clusters at every state count (shipped: 8 up to 384)
  smem_table  the table slice read from shared memory every frame, each lane
              its own float4 slots (shipped: held in registers)
  wait_cta    the row waits acquire at CTA scope (shipped: cluster scope,
              which the stores of other blocks need by the memory model)
  test_wait   the row waits spin on mbarrier.test_wait, which never
              suspends the thread (shipped: try_wait)
  clocked     shipped, with clock64 around each part of a frame in lane 0
              of every warp of window 0's first block: the observation
              ring, the wait for the row, the candidates through the
              reduction and the remote store, and the rest; mean SM cycles
              per frame for each warp (its output is not a decode)
K8 variants:
  shipped     the backpointer pass, then the chase
  pass_only   the pass alone (the chase's time is the difference)
Shapes: tonet's shaped matrix at 361 states over one track of 32,768 frames
and over 8 windows of 6,144 frames in one launch (the time-sharded decode's
blocks at halo 1024); imm's analytic matrix at 722 states over one track of
4,096 frames. Log observations uniform in [-20, 0) from a seeded generator.
Every K7 variant must give the shipped t1_last and t1m1, bit for bit; the
script fails otherwise. Prints the card's name and power limit, then one
JSON line per shape and kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from viterbi_spl_tpu_torch import cuda_lib  # noqa: E402
from viterbi_spl_tpu_torch.hmm import params as hmm_params  # noqa: E402
from viterbi_spl_tpu_torch.hmm import viterbi_dense as VD  # noqa: E402
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params  # noqa: E402

SOURCE = cuda_lib.CSRC / "viterbi_window.cu"
SMEM_TABLE = [
    ("""  float4 tab[kVec];
  const float* brow = logB + static_cast<size_t>(min(s, S - 1)) * S;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int x = 4 * (g + VSPL_WIN_LANES * k);
    tab[k].x = x < S ? __ldg(brow + x) : 0.0f;
    tab[k].y = x + 1 < S ? __ldg(brow + x + 1) : 0.0f;
    tab[k].z = x + 2 < S ? __ldg(brow + x + 2) : 0.0f;
    tab[k].w = x + 3 < S ? __ldg(brow + x + 3) : 0.0f;
  }""", """  float4* tabs = reinterpret_cast<float4*>(ring + VSPL_RING * kG * ring_w) + j * (P / 4);
  const float* brow = logB + static_cast<size_t>(min(s, S - 1)) * S;
  for (int k = 0; k < kVec; ++k) {
    const int x = 4 * (g + VSPL_WIN_LANES * k);
    tabs[g + VSPL_WIN_LANES * k] = make_float4(
        x < S ? __ldg(brow + x) : 0.0f, x + 1 < S ? __ldg(brow + x + 1) : 0.0f,
        x + 2 < S ? __ldg(brow + x + 2) : 0.0f, x + 3 < S ? __ldg(brow + x + 3) : 0.0f);
  }"""),
    ("""          const float4 v = prev[g + VSPL_WIN_LANES * k];
          a0 = fmaxf(a0, v.x + tab[k].x);
          a1 = fmaxf(a1, v.y + tab[k].y);
          a2 = fmaxf(a2, v.z + tab[k].z);
          a3 = fmaxf(a3, v.w + tab[k].w);""", """          const float4 v = prev[g + VSPL_WIN_LANES * k];
          const float4 tk = tabs[g + VSPL_WIN_LANES * k];
          a0 = fmaxf(a0, v.x + tk.x);
          a1 = fmaxf(a1, v.y + tk.y);
          a2 = fmaxf(a2, v.z + tk.z);
          a3 = fmaxf(a3, v.w + tk.w);"""),
    ("""(2 * kG * 64 * kVec + VSPL_RING * kG * 2 * warps) * sizeof(float);""",
     """(2 * kG * 64 * kVec + VSPL_RING * kG * 2 * warps + 2 * warps * 64 * kVec) *
                      sizeof(float);"""),
]
WAIT = "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
RULE = "const int c0 = S <= 8 * VSPL_WIN_CHUNK ? 8 : 16;"
VARIANTS = {
    "shipped": [],
    "cluster16": [(RULE, "const int c0 = 16;")],
    "smem_table": SMEM_TABLE,
    "wait_cta": [(WAIT, WAIT.replace(".acquire.cluster", ""))],
    "test_wait": [(WAIT, WAIT.replace("try_wait", "test_wait"))],
    "clocked": [
        ("""  if (in_loop) {
    for (int t = 1; t < max_len; ++t) {
""", """  long long acc[4] = {0, 0, 0, 0};
  if (in_loop) {
    for (int t = 1; t < max_len; ++t) {
      const long long c0 = clock64();
"""),
        ("""      vspl_mbar_wait(vspl_smem_addr(&bar[b]), (r >> 1) & 1);
""", """      const long long c1 = clock64();
      vspl_mbar_wait(vspl_smem_addr(&bar[b]), (r >> 1) & 1);
      const long long c2 = clock64();
      long long c3 = c2;
"""),
        ("""        if (sender) vspl_store_remote((b ? row0 : row1) + 4u * i * P, nv, b ? bar0 : bar1);
""", """        if (sender) vspl_store_remote((b ? row0 : row1) + 4u * i * P, nv, b ? bar0 : bar1);
        c3 = clock64();
"""),
        ("""      stage(t + VSPL_RING);
    }
  }
""", """      stage(t + VSPL_RING);
      const long long c4 = clock64();
      acc[0] += c1 - c0;
      acc[1] += c2 - c1;
      acc[2] += c3 - c2;
      acc[3] += c4 - c3;
    }
  }
"""),
        ("""  vspl_wait_all_rows();
  cluster.sync();
}
""", """  vspl_wait_all_rows();
  cluster.sync();
  if (win0 == 0 && rank == 0 && lane == 0 && in_loop && max_len > 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t1_last[4 * warp + i] = static_cast<float>(acc[i]) / (max_len - 1);
  }
}
"""),
    ],
    "pass_only": [("""  return static_cast<int>(vspl_launch_chase(static_cast<const int*>(bp), start_states, lengths,
                                            states, N, W, Sp, st));
""", "  return 0;\n")],
}
K7_VARIANTS = ("shipped", "cluster16", "smem_table", "wait_cta", "test_wait")
K8_VARIANTS = ("shipped", "pass_only")


def build_all() -> dict:
    """{variant: loaded library}, one nvcc per variant, all started together."""
    out_dir = cuda_lib.BUILD_DIR / "window_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    # the shared header inlined, so that a variant can patch its mbarrier wait
    base = SOURCE.read_text().replace('#include "viterbi_common.cuh"',
                                      (cuda_lib.CSRC / "viterbi_common.cuh").read_text())
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the shipped source no longer has {old[:60]!r}")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        so.vspl_error_string.argtypes = [ctypes.c_int]
        so.vspl_error_string.restype = ctypes.c_char_p
        for fn, argtypes in VD._WINDOW_SIGNATURES.items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        libs[name] = so
    return libs


def cuda_ms(fn, iters=5) -> float:
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


def sm_clock_mhz() -> str:
    """The SM clock nvidia-smi reads now (the card sets it itself)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_window_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    dev = torch.device("cuda")
    P, stream = cuda_lib.ptr, cuda_lib.stream_ptr(dev)
    rng = np.random.default_rng(0)
    walk = [np.clip(180 + np.cumsum(rng.integers(-3, 4, 5000)), 0, 359)]
    stats = hmm_params.count_statistics(walk, 360)
    tonet = (hmm_params.shape_transition_matrix(stats.transition_counts,
                                                np.array([[0.98, 0.02], [0.02, 0.98]]), 360, 14, floor=2),
             hmm_params.shape_init_probs(stats.p_steady, p_th=1e-4))
    imm = (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))
    shapes = [("tonet 361 track", tonet, 1, 32768, [0]),
              ("tonet 361, 8 windows at halo 1024", tonet, 8, 6144, [0] + [1024] * 7),
              ("imm 722 track", imm, 1, 4096, [0])]
    for label, (A, pi), N, W, resets in shapes:
        S = A.shape[0]
        log_B, log_pi = (torch.from_numpy(x).to(dev) for x in prepare_log_params(A, pi))
        g = torch.Generator(device=dev).manual_seed(7)
        log_obs = torch.rand((N, W, S), generator=g, device=dev).mul_(20.0).sub_(20.0)
        lens = torch.full((N,), W, dtype=torch.int32, device=dev)
        rst = torch.tensor(resets, dtype=torch.int32, device=dev)
        outs = {}

        def k7(name):
            t1m1 = torch.empty_like(log_obs)
            t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
            rc = libs[name].vspl_window_forward(P(log_obs), P(log_B), P(log_pi), P(lens), P(rst),
                                                P(t1m1), P(t1_last), N, W, S, stream)
            if rc:
                raise RuntimeError(f"K7 {name}: {libs[name].vspl_error_string(rc)}")
            outs[name] = (t1_last, t1m1)

        for name in K7_VARIANTS:
            k7(name)
        torch.cuda.synchronize()
        want = outs["shipped"]
        for name in K7_VARIANTS:
            if not (torch.equal(outs[name][0], want[0]) and torch.equal(outs[name][1], want[1])):
                raise RuntimeError(f"K7 {name} differs from the shipped kernel on {label}")
        t1m1 = want[1]
        start = torch.argmax(want[0], dim=1).to(torch.int32)
        outs.clear()

        def k8(name):
            states = torch.empty((N, W), dtype=torch.int32, device=dev)
            bp = torch.empty((N, W, -(-S // 4) * 4), dtype=torch.int32, device=dev)
            rc = libs[name].vspl_window_backtrace(P(t1m1), P(log_B), P(start), P(lens), P(states),
                                                  P(bp), N, W, S, stream)
            if rc:
                raise RuntimeError(f"K8 {name}: {libs[name].vspl_error_string(rc)}")

        # where a frame goes: the clocked variant's per-warp cycles
        k7("clocked")
        torch.cuda.synchronize()
        chunk = -(-S // (8 if S <= 384 else 16))
        warps = (chunk + 1) // 2
        cyc = outs.pop("clocked")[0][0, : 4 * warps].view(warps, 4).cpu().numpy()
        print(json.dumps({"shape": label, "kernel": "K7 clocked", "warps": warps,
                          "sm_clock_mhz": sm_clock_mhz(),
                          "cycles_per_frame": {part: cyc[:, i].round(1).tolist() for i, part in
                                               enumerate(("ring", "wait", "compute_send", "rest"))}}),
              flush=True)

        for kernel, fn, names in (("K7", k7, K7_VARIANTS), ("K8", k8, K8_VARIANTS)):
            order = list(names) + list(reversed(names))
            readings = {n: [] for n in names}
            for n in order:
                readings[n].append(cuda_ms(lambda n=n: fn(n)))
            rec = {"shape": label, "kernel": kernel, "N": N, "W": W, "S": S,
                   "cluster_blocks": libs["shipped"].vspl_window_cluster_size(S),
                   "ms": {n: float(np.mean(r)) for n, r in readings.items()},
                   "readings_ms": readings}
            print(json.dumps(rec), flush=True)
        del log_obs, t1m1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
