"""The benchmark of viterbi_spl_tpu_torch: runs one cell once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m perfbench.run ...   (the same, from the checkout's root)

A cell is an entry of BENCHMARK.json's `workloads`; harness.py says where
its configuration, traffic mix, driver, limits and metric readers live.
The run makes its inputs and weights from --seed on the card, warms up
every shape the cell uses (set-up, reported as `setup_s`), measures for
--seconds, then checks what the timed path produced against the plain
reference (perfbench/reference/) and prints one JSON line last on
standard output: correct, attempted, failed, metrics, device and, with
--trace 1, breakdown. With --trace 0 the metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from spans and the
profiler's trace of the same window. Each compared number is printed
beside its limit, as the last lines on standard error and under "checks",
the result's last key.

- A run needs a CUDA card, as many as the cell names under "chips": without
  one it exits with code 2 and prints no result. There is no CPU fallback.
- The program's CUDA kernels build with nvcc at first use into
  viterbi_spl_tpu_torch/_build/ inside the checkout, so only a cell's first
  run in a checkout compiles. Any torch extension, Triton or CUDA JIT cache
  goes to .perfbench_cache/ at the checkout's root, a fixed path.
- A run writes only inside the checkout and under HOME, XDG_CACHE_HOME and
  TMPDIR: nothing in /dev/shm and no fixed /tmp path. It writes little: the
  kernel libraries once a checkout (a few MiB), and no trace file.
- It exits non-zero with no result when JAX, flax, optax, orbax or the JAX
  package (viterbi_spl_tpu) is loaded once the window has closed, and when
  the program is absent from the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, before torch loads."""
    cache = root / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(cache / sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """Run one cell; returns the exit code. `root` holds BENCHMARK.json and
    the data files; `device` is for the benchmark's own tests: a device
    other than the card skips the look for one."""
    args = parse(argv)
    cache_env(root)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.harness import Cell, forbidden_modules, judge, load_reader

    cell = Cell(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    from perfbench.tracing import Recorder
    from perfbench.work import PEAKS

    driver = cell.driver_class()(cell.config, cell.traffic, args.seed, device)
    t_setup = time.perf_counter()
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"perfbench: set-up {setup_s:.3f} s, of which the driver's {time.perf_counter() - t_setup:.3f} s",
          file=sys.stderr)

    rec = Recorder(trace=bool(args.trace), sync=device.type == "cuda")
    e2e = driver.run(args.seconds, rec)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e["setup_s"] = setup_s

    metrics = {}
    if args.trace:
        for m in cell.per_layer():
            value = load_reader(m["name"])(driver.layer_view(rec))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    driver.release()
    numbers = driver.check()
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3

    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in cell.limits.items()}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
        dev["peaks"] = PEAKS
    out = {"correct": driver.failed == 0 and judge(numbers, cell.limits),
           "attempted": driver.attempted, "failed": driver.failed, "metrics": metrics,
           "device": dev}
    if args.trace and rec.result is not None:
        print(f"perfbench: trace of {len(rec.result.device)} device operations, "
              f"{100 * rec.result.matched:.1f} % matched to their launch", file=sys.stderr)
        dev["busy_s"] = rec.result.busy_s
        dev["window_s"] = rec.result.window_s
        out["breakdown"] = {"device_ops": rec.result.device_ops(),
                            "idle_gaps": rec.result.idle_gaps()}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
