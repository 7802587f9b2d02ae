"""Spans on the host clock, and the device trace of a `--trace 1` run.

`Recorder.span(name)` times a call into one of the program's layers on the
host clock, ending in `torch.cuda.synchronize()`. `Recorder.open` and
`close` bound the measured window; in a traced run the profiler runs around
it with CUDA activities only (CUPTI: kernels, copies, sets and the CUDA
runtime calls), since recording every host-side operator as well doubled
the time of a TONet training step. The profiler stamps its events on the system clock
(time.time_ns), and so do the spans and the window, which places them on
one timeline. `Trace` reads the events once the window has closed: every
device operation clipped to the window, and the runtime calls, which with
the spans name the idle gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

class Recorder:
    def __init__(self, trace: bool, sync: bool = True):
        self.trace = trace
        self.sync = sync
        self.spans: dict[str, list] = defaultdict(list)
        self.window_start = self.window_end = None
        self.result: Trace | None = None

    def wait(self):
        """Wait for the device's queued work (a no-op off the card)."""
        if self.sync:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, wait: bool = True):
        ns, t0 = time.time_ns(), time.perf_counter()
        yield
        if wait:
            self.wait()
        self.spans[name].append((t0, time.perf_counter()))
        self.notes.append((name, ns, time.time_ns()))

    def open(self):
        """Start the profiler (traced runs) and the window's clock."""
        self.notes = []
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            # off the card (the benchmark's own tests) only the host to trace
            activity = ProfilerActivity.CUDA if self.sync else ProfilerActivity.CPU
            self._prof = profile(activities=[activity])
            self._prof.__enter__()
        self._ns = time.time_ns()
        self.window_start = time.perf_counter()

    def close(self):
        """End the window (after the last request's synchronising copy) and
        read the trace."""
        self.window_end = time.perf_counter()
        if self.trace:
            end_ns = time.time_ns()
            self._prof.__exit__(None, None, None)
            self.result = Trace(self._prof, self._ns, end_ns, self.notes)
            self._prof = None

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def total(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ()))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The profiler's events of one window, times in ns on its clock."""

    def __init__(self, prof, start_ns: int, end_ns: int, notes):
        device, host, self.launched = [], [], {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append((name, s, s + d, e.correlation_id() or e.linked_correlation_id()))
            else:
                host.append((s, s + d, name))
                for c in (e.correlation_id(), e.linked_correlation_id()):
                    if c:
                        self.launched[c] = s
        self.start, self.end = start_ns, end_ns
        self.device = [(n, max(s, self.start), min(e, self.end), c)
                       for n, s, e, c in device if e > self.start and s < self.end]
        self.notes = list(notes)
        self.host = sorted(host)
        self.matched = sum(c in self.launched for *_, c in self.device) / max(len(self.device), 1)
        self.busy = _union((s, e) for _, s, e, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernels(self, patterns=None):
        """(name, start, end, correlation) of the device operations whose
        name holds any of `patterns` (all when None)."""
        return [k for k in self.device
                if patterns is None or any(p in k[0] for p in patterns)]

    def seconds(self, patterns) -> float:
        return sum(e - s for _, s, e, _ in self.kernels(patterns)) / 1e9

    def launched_in(self, spans) -> float:
        """Device seconds of the operations whose CUDA runtime call (launch
        or copy) was made inside one of the host `spans` (time_ns pairs)."""
        spans = sorted(spans)
        starts = [a for a, _ in spans]
        total = 0
        for _, s, e, c in self.device:
            t = self.launched.get(c)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total / 1e9

    def device_ops(self, top: int = 10):
        total = defaultdict(int)
        for n, s, e, _ in self.device:
            total[n] += e - s
        return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def _host_at(self, t: int) -> str:
        """The innermost annotation and host operation running at time t."""
        where = [n for n, s, e in self.notes if s <= t <= e]
        starts = [h[0] for h in self.host]
        i = bisect.bisect_right(starts, t) - 1
        op = None
        for j in range(i, max(i - 5000, -1), -1):
            if self.host[j][1] >= t:
                op = self.host[j][2]
                break
        label = "/".join(where[-1:] + [op or "python"])
        return label

    def idle_gaps(self, top: int = 10):
        edges = [(self.start, self.start)] + [tuple(b) for b in self.busy] + [(self.end, self.end)]
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(edges, edges[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        return [[self._host_at((s + e) // 2), g / 1e9] for g, s, e in gaps[:top]]

    def spans(self, name: str):
        """The benchmark's host spans `name`, time_ns pairs."""
        return sorted((s, e) for n, s, e in self.notes if n == name)
