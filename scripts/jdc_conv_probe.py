"""Which float32 convolution algorithm should run JDC's conv stack on the
card: each convolution of models/jdc.py's stack (conv1_1 to block 4, at
31 frames a chunk and 513 bins) at chunk batches of 13, 26 and 42 (a MIR-1K
clip's batch), in four versions, all under apps/common.py's float32_math
(TF32 off):

- heuristic: cuDNN's heuristic choice (benchmark off), as float32_math
  leaves it;
- benchmark: cuDNN's measured choice (benchmark on, TF32 still off);
- nhwc: channels-last tensors and weights (converted once), heuristic;
- nhwc_benchmark: channels-last, measured choice;
- benchmark_all: measured among every algorithm cuDNN offers
  (benchmark_limit 0; PyTorch's default measures its first 10).

For each: ms a call (median of REPS between CUDA events after WARMUP),
TFLOP/s against the 67 TFLOP/s float32 peak, the first call at the shape
(cuDNN's measuring where benchmark is on), the largest difference from a
float64 convolution on the host over the latter's largest magnitude, and
the device kernels one call launches (torch.profiler). Then the whole conv
stack as JDC.forward runs it (BatchNorm on running averages, the pools; in
nhwc versions with the layout's conversion in and out), a clip's batch at
a time, and the cost of meeting each other batch size from 13 to 42 (the
first call of each, less a second call). Each version runs in a process of
its own (see run_version).

    python3 scripts/jdc_conv_probe.py [--out FILE] [--batches 13 26 42]
                                      [--versions heuristic benchmark ...]

(models/jdc.py runs the stack at a batch rounded up to a multiple of
BATCH_STEP: `--batches 16 24 32 40 48` gives the shapes a MIR-1K clip runs.)

Prints a table with the card's name and power limit, and writes the JSON
of every measurement to --out when given; exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.apps.common import float32_math  # noqa: E402
from viterbi_spl_tpu_torch.models.jdc import JDC, _lrelu, _pool14  # noqa: E402

WARMUP, REPS = 3, 20
BATCHES = (13, 26, 42)
SWEEP = range(13, 43)
PEAK = 67e12
T_CHUNK, BINS = 31, 513
# version: (benchmark, channels-last, benchmark_limit)
VERSIONS = {"heuristic": (False, False, 10), "benchmark": (True, False, 10),
            "nhwc": (False, True, 10), "nhwc_benchmark": (True, True, 10),
            "benchmark_all": (True, False, 0)}


def algorithm(benchmark: bool, limit: int):
    return torch.backends.cudnn.flags(enabled=True, benchmark=benchmark, benchmark_limit=limit,
                                      deterministic=False, allow_tf32=False)


def layout(x, nhwc: bool):
    return x.contiguous(memory_format=torch.channels_last) if nhwc else x.contiguous()


def events_ms(fn) -> float:
    out = []
    for i in range(WARMUP + REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            out.append(start.elapsed_time(end))
    return statistics.median(out)


def first_call_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def kernels(fn) -> list[str]:
    """Names of the device kernels one call launches, in order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda and not e.is_user_annotation())
    return [n for _, n in events]


def convs(model):
    """(name, module, input channels, width) of the stack's convolutions."""
    out = [("conv1_1", model.conv1_1, 1, BINS), ("conv1_2", model.conv1_2, 64, BINS)]
    width = BINS // 4
    for b in ("block2", "block3", "block4"):
        block = getattr(model, b)
        c_in = block.conv_1.weight.shape[1]
        c_out = block.conv_1.weight.shape[0]
        out += [(f"{b}.conv_1x1", block.conv_1x1, c_in, width),
                (f"{b}.conv_1", block.conv_1, c_in, width),
                (f"{b}.conv_2", block.conv_2, c_out, width)]
        width //= 4
    return out


def flops(conv, n: int, width: int) -> float:
    w = conv.weight
    return 2.0 * n * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3] * T_CHUNK * width


def stack(model, x, nhwc: bool):
    """JDC.forward's conv stack, x [n, 31, 513] -> block 4 pooled, NCHW."""
    h = layout(x[:, None], nhwc)
    b1 = model.conv1_1(h)
    b1 = model.conv1_2(_lrelu(model.bn1(b1)))
    b4 = model.block4(model.block3(model.block2(b1)))
    return _pool14(_lrelu(model.bn4(b4))).contiguous()


def run_version(version: str, dev, batches) -> dict:
    """The measurements of one version, in a process of its own: cuDNN
    caches the algorithm it picks for a shape (heuristic or measured) under
    a key that does not hold the benchmark flag, so a shape met in one
    version would keep its algorithm in the next."""
    bench, nhwc, limit = VERSIONS[version]
    torch.manual_seed(0)
    model = JDC().to(dev).eval()
    if nhwc:
        model.to(memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(1)
    out = {"convs": [], "stack": {}}
    with torch.no_grad(), float32_math(dev), algorithm(bench, limit):
        # each convolution alone, each shape met here first
        for name, conv, c_in, width in convs(model):
            w64 = conv.weight.detach().double().cpu()
            for n in batches:
                x = torch.randn(n, c_in, T_CHUNK, width, generator=gen)
                y64 = F.conv2d(x.double(), w64, padding="same")
                xin = layout(x.to(dev), nhwc)
                first = first_call_ms(lambda: conv(xin))
                ms = events_ms(lambda: conv(xin))
                gap = (conv(xin).double().cpu() - y64).abs().max().item() / y64.abs().max().item()
                f = flops(conv, n, width)
                out["convs"].append({"conv": name, "batch": n, "c_in": c_in,
                                     "c_out": int(conv.weight.shape[0]),
                                     "kernel": list(conv.weight.shape[2:]), "width": width,
                                     "gflop": f / 1e9, "ms": ms, "tflops": f / (ms / 1e3) / 1e12,
                                     "pct_peak": 100 * f / (ms / 1e3) / PEAK, "first_ms": first,
                                     "rel_gap_f64": gap, "kernels": kernels(lambda: conv(xin))})

        # the whole stack, a clip's batch at a time (every conv's shape met)
        stack_flops = sum(flops(c, 1, w) for _, c, _, w in convs(model))
        for n in batches:
            x = torch.randn(n, T_CHUNK, BINS, generator=gen).to(dev)
            ms = events_ms(lambda: stack(model, x, nhwc))
            torch.cuda.reset_peak_memory_stats(dev)
            stack(model, x, nhwc)
            torch.cuda.synchronize()
            out["stack"][str(n)] = {"ms": ms, "tflops": n * stack_flops / (ms / 1e3) / 1e12,
                               "peak_bytes": torch.cuda.max_memory_allocated(dev)}

        # every other batch size of a clip: its first call less a second
        first, again = [], []
        for n in SWEEP:
            if n in batches:
                continue
            x = torch.randn(n, T_CHUNK, BINS, generator=gen).to(dev)
            first.append(first_call_ms(lambda: stack(model, x, nhwc)))
            again.append(first_call_ms(lambda: stack(model, x, nhwc)))
        out["sweep"] = {"sizes": len(first), "first_ms": first, "again_ms": again,
                        "measuring_s_a_size": (sum(first) - sum(again)) / 1e3 / len(first)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="file for the JSON result")
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES),
                    help="chunk batches each convolution and the stack are timed at")
    ap.add_argument("--versions", nargs="+", choices=VERSIONS, default=list(VERSIONS),
                    help="the versions to measure, the first the one the others are read against")
    ap.add_argument("--version", choices=VERSIONS, default=None,
                    help="measure this version alone and print its JSON (one process a version)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("jdc_conv_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.set_num_threads(8)
    if args.version is not None:
        print(json.dumps(run_version(args.version, torch.device("cuda"), args.batches)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    result = {"device": smi, "torch": torch.__version__, "cudnn": torch.backends.cudnn.version()}
    versions = args.versions
    for version in versions:
        done = subprocess.run([sys.executable, __file__, "--version", version, "--batches",
                               *map(str, args.batches)], capture_output=True, text=True)
        if done.returncode != 0:
            print(f"jdc_conv_probe: {version} failed:\n{done.stderr}", file=sys.stderr)
            return 1
        result[version] = json.loads(done.stdout.strip().splitlines()[-1])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))

    print("per conv: ms (TFLOP/s) first-call ms, gap to float64")
    for i, entry in enumerate(result[versions[0]]["convs"]):
        rows = ((v, result[v]["convs"][i]) for v in versions)
        head = f"{entry['conv']:17s} n={entry['batch']:2d} {entry['gflop']:6.2f} GFLOP  "
        print(head + "  ".join(
            f"{v} {r['ms']:.3f} ({r['tflops']:.1f}) {r['first_ms']:.0f} {r['rel_gap_f64']:.1e}"
            for v, r in rows))
    for n in args.batches:
        rows = ((v, result[v]["stack"][str(n)]) for v in versions)
        print(f"stack n={n}: " + "  ".join(f"{v} {r['ms']:.3f} ms ({r['tflops']:.2f} TF/s, peak "
                                            f"{r['peak_bytes'] / 1e9:.2f} GB)" for v, r in rows))
    print("measuring a new batch size: " + "  ".join(
        f"{v} {result[v]['sweep']['measuring_s_a_size'] * 1e3:.1f} ms" for v in versions))
    for i, entry in enumerate(result[versions[0]]["convs"]):
        print(entry["conv"], entry["batch"], {v: sorted(set(result[v]["convs"][i]["kernels"]))
                                              for v in versions})
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
