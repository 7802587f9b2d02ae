"""Where a TONet train step's time goes on the GPU (the training path of
apps/common.py at TONet's published width: 360 bins, attn_dim 2048, mode
"all", batch 4 x 128 frames), each part timed between CUDA events, the
median of REPS after WARMUP:

- forward: the model in training mode (batch statistics, the dropouts) and
  the loss, under float32_math, no autograd kept;
- forward + backward: the same with loss.backward();
- optimizer: ScheduledAdam's step over the gradients left by a backward;
- step: make_train_step's whole step (zero_grad, forward, backward, Adam,
  the training-split counts), each followed by a synchronize, and the
  same REPS steps back to back with one synchronize at the end;
- a torch.profiler window of 3 steps: the device's busy time a step (the
  kernels' durations summed) and the ops and kernels by device time
  (printed, and written to --profile-out when given).

    python3 scripts/gpu_train_probe.py [--profile-out FILE]

Prints one JSON line with the card's name and power limit; exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from viterbi_spl_tpu_torch.apps import common as AC  # noqa: E402
from viterbi_spl_tpu_torch.apps import tonet as tonet_app  # noqa: E402

WARMUP, REPS = 2, 7


def events_ms(fn, reps=REPS, warmup=WARMUP) -> list[float]:
    out = []
    for i in range(warmup + reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        if i >= warmup:
            out.append(start.elapsed_time(end))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-out", type=Path, default=None,
                    help="file for the profiler's table of ops and kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpu_train_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = tonet_app.config()
    model, params, stats = AC.init_model(cfg, seed=41, device=dev)
    opt = AC.make_optimizer(cfg, model, 20)
    step = AC.make_train_step(cfg, model)
    train = AC.synthetic_dataset(cfg, 6, 2000, 0)
    stream = AC.training_batches(cfg, train, np.random.default_rng(0), dev)
    batches = [next(stream) for _ in range(WARMUP + REPS)]

    def prepared(i):
        spec, notes = batches[i % len(batches)]
        return cfg.input_adapter(spec), notes

    def forward(i, backward=False):
        spec, notes = prepared(i)
        model.train()
        with AC.float32_math(dev), torch.set_grad_enabled(backward):
            loss = cfg.loss_fn(notes, model(spec, dropout=AC.dropout_generator(i, dev)))
            if backward:
                opt.zero_grad(set_to_none=True)
                loss.backward()

    res = {"device": smi, "params": sum(p.numel() for p in params.values()),
           "frames_per_step": cfg.batch_size * cfg.snippet_len}
    res["forward_ms"] = events_ms(forward)
    res["forward_backward_ms"] = events_ms(lambda i: forward(i, backward=True))
    res["optimizer_ms"] = events_ms(lambda i: opt.step())
    res["step_ms"] = events_ms(lambda i: step(params, stats, opt, batches[i], i, 0.5))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(REPS):
        step(params, stats, opt, batches[i], i, 0.5)
    end.record()
    end.synchronize()
    res["step_ms_back_to_back"] = start.elapsed_time(end) / REPS
    for k in ("forward_ms", "forward_backward_ms", "optimizer_ms", "step_ms"):
        res[k.replace("_ms", "_median_ms")] = float(np.median(res[k]))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(params, stats, opt, batches[i], i, 0.5)
        torch.cuda.synchronize()
    # the device's busy time: the kernels' own durations (the ops' and the
    # optimizer annotation's device rows repeat their kernels' time)
    kernels_us = sum(e.self_device_time_total for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.name
                     and not e.name.startswith(("aten::", "Optimizer")))
    res["profile_device_busy_ms_per_step"] = kernels_us / 1e3 / 3
    events = prof.key_averages()
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    if args.profile_out is not None:
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        args.profile_out.write_text(f"{smi}\n{table}\n")
    print(table[:6000], flush=True)
    print(smi, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
