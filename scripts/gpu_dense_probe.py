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
   streams x 33 rows: the carry and 32 frames) at both state counts. Both
   routes' t1_last and t1m1 must be equal below each length, bit for bit.

    python3 scripts/gpu_dense_probe.py

Prints the card's name and power limit, then one JSON line per reading.
K3's cluster count comes from a copy of its source with one query entry
appended, built here with the port's nvcc flags, K7's from
viterbi_dense.window_max_clusters; the timings call the port's wrappers. It
is a measurement, not a decoder.
"""

from __future__ import annotations

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
    return ctypes.CDLL(str(lib))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_dense_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cuda_lib.build()
    query = build_query()
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
    imm = (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))
    rnd = dense_matrix(361, 2)
    shapes = [("imm 722", imm, np.full(16, 4096, np.int32)),
              ("imm 722 main path", imm, np.array([1500, 700, 1100, 500], np.int32)),
              ("random 361", rnd, np.full(16, 4096, np.int32)),
              ("imm 722 streaming push", imm, np.full(64, 33, np.int32)),
              ("random 361 streaming push", rnd, np.full(64, 33, np.int32))]
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
                               for r, v in ms.items()}})
        del log_obs
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
