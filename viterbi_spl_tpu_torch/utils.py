"""Runtime utilities (counterpart of viterbi_spl_tpu/utils.py): device
selection, logging, timing and profiling, the multi-process runtime.

- resolve_device / on_device — the device an entry point runs on (CUDA
  unless asked otherwise, never a silent fall back to the CPU),
- configure_logging — the reference's DEBUG-gated logging with per-library
  suppression (dcnet/softmax_viterbi.py:89-123), stdlib-only,
- Timer / profile_trace — wall-clock spans (tracing.timed), and
  torch.profiler traces that TensorBoard's profiler plugin and Perfetto
  read, the program's spans among them (tracing.py),
- initialize_distributed / process_count / process_index — the
  torch.distributed runtime over several processes (gloo: NCCL cannot run
  two ranks on one card, dist/mesh.py),
- device_summary — the device inventory for logs,
- shape_bucket — the JAX package's geometric padded-shape policy, kept
  with its arithmetic (the eager port compiles nothing per shape, so its
  decoders do not pad to buckets).
"""

from __future__ import annotations

import contextlib
import logging

import torch

from . import tracing


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises when CUDA is wanted (explicitly or by default) and
    absent, so that a run never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    return dev


def on_device(device: torch.device):
    """A context that makes `device` the current CUDA device (a kernel
    launches on the current device's stream); nothing for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shape_bucket(
    n: int, quantum: int, ratio: float = 1.25, minimum: int | None = None
) -> int:
    """Smallest bucket >= n from the geometric grid {minimum, ~ratio x, ...}
    where every bucket is a multiple of `quantum`."""
    if n <= 0:
        raise ValueError(f"shape_bucket needs n >= 1, got {n}")
    b = minimum if minimum is not None else quantum
    if b <= 0 or b % quantum:
        raise ValueError(f"minimum {b} must be a positive multiple of quantum {quantum}")
    while b < n:
        # the +quantum floor guarantees progress when int(b * ratio)
        # rounds back to a multiple of quantum <= b (e.g. small quantum)
        b = max(-(-int(b * ratio) // quantum) * quantum, b + quantum)
    return b


def configure_logging(debug: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    for noisy in ("torch", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


class Timer:
    """Accumulating wall-clock timer: `with timer.span("viterbi"): ...`. Each
    span is a `tracing.timed` span (recorded while tracing records), whose
    seconds add to the timer's totals."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        sp = tracing.timed(name)
        try:
            with sp:
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + sp.seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot:.3f}s total, {n} calls, {tot/n*1e3:.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA where there is a
    card), its trace written under log_dir as a Chrome trace file that
    TensorBoard's profiler plugin and Perfetto read."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
    with prof:
        yield prof


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join num_processes processes into one torch.distributed runtime (gloo)
    over coordinator_address ("host:port", process 0 listens there). One
    process, or no arguments, is a no-op. With no address but a count, the
    address comes from the environment (MASTER_ADDR, MASTER_PORT)."""
    import torch.distributed as dist

    if num_processes in (None, 1) and coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and process_id")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group("gloo", init_method=init, world_size=int(num_processes),
                            rank=int(process_id))


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device_summary() -> str:
    devs = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    if not devs:
        devs = ["cpu"]
    kinds: dict[str, int] = {}
    for d in devs:
        kinds[d] = kinds.get(d, 0) + 1
    parts = [f"{n}x {k}" for k, n in kinds.items()]
    return f"{len(devs)} devices ({', '.join(parts)}), {process_count()} process(es)"
