"""The unvoiced lane of K5/K6 (viterbi_spl_tpu_torch/csrc/obs.cu) against
its plain version, frame by frame, on the GPU.

Builds the inputs of tests/test_torch_kernels.py's K5/K6 tests the way they
do (the same seed, the same order of draws: contract_logits, then the
prior) and, for every case of those tests, reads every frame's unvoiced
lane:

- want (the plain version on the card), got (the kernel), |got - want|;
- p, the frame's count of terms in the softmax denominator: the voiced
  lanes of `want` above log TINY, plus the non-melody (vth) term;
- the bound of a float32 sum of p positive terms in any order, a relative
  error of at most (p - 1) 2^-24 in the denominator, which is an absolute
  (p - 1) 2^-24 on the log;
- whether |diff| <= 1e-6 |want| (the contract's clause before the
  repair) and whether |diff| <= 1e-6 |want| + (p + 1) 2^-24 (after it).

Prints the card's name and power limit, then one JSON line per case (its
worst frame by |diff| / ((p - 1) 2^-24), and the frames that miss the
rtol-only clause, each with its numbers), and a summary line.

    python3 scripts/gpu_obs_unvoiced_probe.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.hmm import obs_fused as OF  # noqa: E402

SEED = 20261016  # tests/test_torch_kernels.py's rng fixture
EPS = 2.0 ** -24


def obs_cfg(rng, method, n_bins, spw):
    """tests/test_torch_kernels.py::_obs_cfg."""
    pri = rng.random(n_bins + 1).astype(np.float32) + 0.1
    return dict(method=method, spw=spw, threshold_logit=0.3, init_probs=pri / pri.sum())


def cases():
    """(test, N, T, n_bins, spw, method) of the K5/K6 tests."""
    for method in ("shaun", "softmax-scaled", "softmax-unscaled"):
        for n_bins, spw in ((360, 5), (721, 16), (721, 20)):
            yield "match_plain", 6, 64, n_bins, spw, method
    for method in ("shaun", "softmax-scaled"):
        for n_bins, spw in ((2, 1), (361, 1), (361, 360), (721, 1), (721, 720),
                            (1024, 1), (1024, 1023)):
            yield "tiles_and_alignment", 3, 37, n_bins, spw, method


def frame_numbers(got: np.ndarray, want: np.ndarray):
    n_bins = want.shape[-1] - 1
    w, g = want[..., n_bins].astype(np.float64), got[..., n_bins].astype(np.float64)
    diff = np.abs(g - w)
    p = (want[..., :n_bins] > OF.LOG_TINY_F32 + 1e-3).sum(-1) + 1
    return w, g, diff, p


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_obs_unvoiced_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    worst_ratio, misses_old, misses_new = 0.0, 0, 0
    for test, N, T, n_bins, spw, method in cases():
        rng = np.random.default_rng(SEED)
        lg = torch.from_numpy(OF.contract_logits(rng, N, T, n_bins)).to(dev)
        obs = obs_cfg(rng, method, n_bins, spw)
        got = OF.log_obs(lg, obs).cpu().numpy()
        want = OF.log_obs_plain(lg, obs).cpu().numpy()
        w, g, diff, p = frame_numbers(got, want)
        sum_bound = (p - 1) * EPS
        ratio = np.where(diff > 0, diff / np.maximum(sum_bound, EPS), 0.0)
        old_ok = diff <= 1e-6 * np.abs(w)
        new_ok = diff <= 1e-6 * np.abs(w) + (p + 1) * EPS
        i = np.unravel_index(np.argmax(ratio), ratio.shape)

        def frame(idx):
            return {"frame": [int(v) for v in idx], "want": float(w[idx]), "got": float(g[idx]),
                    "abs_diff": float(diff[idx]), "p": int(p[idx]),
                    "sum_bound_(p-1)eps": float(sum_bound[idx]),
                    "within_sum_bound": bool(diff[idx] <= sum_bound[idx]),
                    "rtol_1e-6_ok": bool(old_ok[idx]), "new_clause_ok": bool(new_ok[idx])}

        missed = [frame(tuple(ix)) for ix in np.argwhere(~old_ok)[:8]]
        worst_ratio = max(worst_ratio, float(ratio.max()))
        misses_old += int((~old_ok).sum())
        misses_new += int((~new_ok).sum())
        print(json.dumps({"test": test, "N": N, "T": T, "n_bins": n_bins, "spw": spw,
                          "method": method, "frames": int(diff.size),
                          "frames_exact": int((diff == 0).sum()),
                          "max_abs_diff": float(diff.max()),
                          "max_diff_over_sum_bound": float(ratio.max()),
                          "worst": frame(i), "missing_rtol_1e-6": missed,
                          "missing_rtol_1e-6_count": int((~old_ok).sum()),
                          "missing_new_clause_count": int((~new_ok).sum()),
                          "contract_ok_now": OF.obs_contract(got, want)["ok"]}), flush=True)
    print(json.dumps({"summary": True, "max_diff_over_sum_bound": worst_ratio,
                      "frames_missing_rtol_1e-6": misses_old,
                      "frames_missing_new_clause": misses_new, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
