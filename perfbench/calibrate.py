"""The readings a cell's limits are set from: for each seed, one process's
set-up, a short window, and the numbers the check compares for the program,
for the control (the reference one precision step below the
configuration's).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--out readings.jsonl]

One JSON line a seed and kind ("program", "control") on
standard output, and in --out when given. The benchmark's own runs never
run this; it needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, root: Path = ROOT, device=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import Cell
    from perfbench.tracing import Recorder

    cell = Cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("calibrate.py needs a CUDA card")
        device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = cell.driver_class()(cell.config, cell.traffic, seed, device)
        driver.setup()
        driver.run(args.seconds, Recorder(trace=False, sync=torch.device(device).type == "cuda"))
        driver.release()
        kinds = [("program", None), ("control", driver.control())]
        for kind, candidate in kinds:
            row = {"workload": args.workload, "seed": seed, "kind": kind,
                   "numbers": driver.check(candidate), "limits": cell.limits,
                   "attempted": driver.attempted, "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
        del driver, candidate, kinds
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return rows


if __name__ == "__main__":
    main()
