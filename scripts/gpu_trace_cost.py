"""What the program's spans (viterbi_spl_tpu_torch/tracing.py) cost and
record.

    python3 scripts/gpu_trace_cost.py --cells tonet.decode,jdc.decode,tonet.transcribe \
        --seed 3100000061 --seconds 20 [--out runs/trace_cost.json]
    python3 scripts/gpu_trace_cost.py --micro      # the CPU: a span's cost

On the card, for each cell: one process sets the cell up as
perfbench/run.py does, then runs traced windows (the profiler on with CUDA
activities, as in a `--trace 1` run) in turns with the program's spans
recording and disabled (`tracing.enabled(False)`): on, off, off, on. For
each window it prints the cell's rate; for the recording windows also the
per-layer metrics BENCHMARK.json names for the cell, the spans a request
(and a clip) opens by name, the buffer's dropped count, how many of the
profiler's host events carry a span's name (record_function under CUDA
activities), the labels of the longest idle gaps, and how long after its
launch call (the host clock) each kernel starts on the device (the
trace's clock): a negative lag is the two clocks apart.

--root and --device cpu rehearse it on a checkout root of tiny cells
(perfbench/tests/tiny.py). --micro times, on the CPU, a disabled span (`with tracing.span(...)` and no
profiler) against an empty `with` of a shared context, and a recording one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def micro(n: int) -> dict:
    """ns a call over an empty loop's: a disabled span and count, a
    recording span without a profiler, and one under a profiler of the CPU
    (with its record_function) and, on a card, of CUDA activities alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from viterbi_spl_tpu_torch import tracing

    clock = time.perf_counter_ns

    def spans():
        t0 = clock()
        for _ in range(n):
            with tracing.span("decode.prepare"):
                pass
        return (clock() - t0) / n

    out = {}
    for _ in range(3):  # the last of three rounds, warm
        t0 = clock()
        for _ in range(n):
            pass
        empty = (clock() - t0) / n
        out = {"disabled_span_ns": spans() - empty}
        t0 = clock()
        for _ in range(n):
            tracing.count("h2d_bytes", 8)
        out["disabled_count_ns"] = (clock() - t0) / n - empty
        with tracing.enabled():
            out["recording_span_ns"] = spans() - empty
        with profile(activities=[ProfilerActivity.CPU]):
            out["profiled_span_ns"] = spans() - empty
        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CUDA]):
                out["cuda_profiled_span_ns"] = spans() - empty
        tracing.clear()
    return out


def card() -> dict:
    import torch

    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "nvidia_smi": q.stdout.strip()}


def requests_opened(spans, clips: int) -> dict:
    """Spans a request opens, by name, and the kernel launches its root
    spans hold (means over the window's requests); spans a clip (over the
    cell's records)."""
    by_request: dict = {}
    launches = Counter()
    for s in spans:
        by_request.setdefault(s.request, Counter())[s.name] += 1
        launches.update(s.attrs.get("launches", {}))
    names = Counter()
    for c in by_request.values():
        names.update(c)
    n = max(len(by_request), 1)
    return {"requests": len(by_request), "spans_a_request": len(spans) / n,
            "spans_a_clip": len(spans) / clips if clips else None,
            "by_name_a_request": {k: v / n for k, v in sorted(names.items())},
            "launches_a_request": {k: v / n for k, v in sorted(launches.items())}}


def run_cell(root: Path, name: str, seed: int, seconds: float, turns: str, device) -> dict:
    import torch

    from perfbench.harness import Cell, load_reader
    from perfbench.tracing import Recorder
    from viterbi_spl_tpu_torch import tracing

    cell = Cell(root, name)
    dev = torch.device(device)
    card = dev.type == "cuda"
    bench = cell.driver_class()(cell.config, cell.traffic, seed, dev)
    t0 = time.perf_counter()
    bench.setup()
    if card:
        torch.cuda.synchronize()
    out = {"cell": name, "seed": seed, "setup_s": time.perf_counter() - t0, "windows": []}
    rate = [m["name"] for m in cell.end_to_end() if m["name"] != "setup_s"][0]
    for turn in turns:
        on = turn == "1"
        tracing.clear()
        rec = Recorder(trace=True, sync=card)
        with contextlib.nullcontext() if on else tracing.enabled(False):
            e2e = bench.run(seconds, rec)
        w = {"spans": "on" if on else "off", rate: e2e[rate], "window_s": rec.result.window_s,
             "busy_s": rec.result.busy_s, "requests": len(bench.records)}
        if on:
            view = bench.layer_view(rec)
            w["metrics"] = {m["name"]: load_reader(m["name"])(view) for m in cell.per_layer()}
            t = rec.result
            kept = [s for s in tracing.spans() if t.start <= s.start <= t.end]
            clips = len(bench.records) if name.endswith("transcribe") else 0
            w["opened"] = requests_opened(kept, clips)
            w["dropped"] = tracing.dropped()
            names = {s.name for s in kept}
            w["host_events_named_as_spans"] = sum(1 for h in t.host if h[2] in names)
            w["idle_gaps"] = t.idle_gaps()
            lags = sorted(s - t.launched[c] for n, s, e, c in t.device
                          if c in t.launched and not n.startswith(("Memcpy", "Memset")))
            if lags:
                w["launch_to_start_ms"] = {"min": lags[0] / 1e6, "median": lags[len(lags) // 2] / 1e6,
                                           "negative_share": sum(x < 0 for x in lags) / len(lags)}
        out["windows"].append(w)
        print(json.dumps(w), flush=True)
    bench.release()
    if card:
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="tonet.decode,jdc.decode,tonet.transcribe")
    ap.add_argument("--seed", type=int, default=3100000061)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--turns", default="1001", help="1: spans recording, 0: disabled")
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.micro:
        result = {"micro": micro(args.n)}
    else:
        result = {"card": card() if args.device == "cuda" else None,
                  "cells": [run_cell(args.root, c, args.seed, args.seconds, args.turns, args.device)
                            for c in args.cells.split(",")]}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
