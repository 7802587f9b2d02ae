"""Spans and counters at the program's layer boundaries, on the profiler's
clock.

A span is a named interval of host time: name, span id, the id of the span
it opened inside (the innermost open span of its thread), a request id,
start and end on `time.time_ns()`, attrs, and the counters bumped while it
was the innermost span. `time.time_ns()` is the clock torch.profiler stamps
its events with, so spans lie on a device trace's timeline as they are.

    with tracing.span("decode.prepare"):
        ...
        tracing.count("tables_built")

- Recording is on while a torch profiler runs
  (`torch.autograd.profiler._is_profiler_enabled`), or inside
  `enabled()`; `enabled(False)` keeps it off under a profiler. Off, `span`
  is one flag test that returns a shared no-op context: nothing is
  allocated or recorded.
- On, each closed span goes to a buffer of CAPACITY spans as a tuple
  whose attrs and counters are flat tuples (k1, v1, k2, v2, ...), each
  made before the tuple that holds it: the garbage collector stops
  tracking all of them at its first pass, so that a filling buffer does
  not set off full collections (pauses of 0.2-0.5 s on the card's host in
  a traced window). It is read with `spans()` as `Record`s; spans past
  CAPACITY are counted by `dropped()` and not kept. While a
  profiler runs, a span also enters a record_function of its name, so a
  `utils.profile_trace` Chrome trace shows the program's spans: torch's C++
  RecordFunction through `_RecordFunctionFast`, the event
  `torch.profiler.record_function` makes at a seventh of its cost, or
  `record_function` itself where torch lacks it.
- The outermost span of a thread opens a new request id, unless the thread
  is inside `request()`, whose root spans share one. A root span holds, as
  its `launches` attr, the kernel launches made inside it
  (`hmm.viterbi_dense.KERNEL_WRAPPERS[*].launches`).
- No span synchronises or reads the card. A layer's device time is that of
  the kernels launched inside its span, which the profiler's trace matches
  to their launch by correlation id.

Counters: `host_waits`, the blocking copies between the host
and a card, each in a `<layer>.wait` span (`wait`, `to_host`, `upload`);
`h2d_bytes` and `d2h_bytes`, the bytes they copy; `tables_built` and
`tables_reused`, the decode's prepared HMM built or found
(`decode.prepare`, hmm/prepared.py); `conv_tunes`, an input shape JDC's
eval-mode conv stack meets first in the process, when cuDNN measures its
algorithms for it (`model.convs`, models/jdc.py). `COUNTERS` names them
all. A copy that is not
non_blocking ends in a synchronise of the stream in PyTorch, from the host
to the card as from the card to the host, so the host waits there for
every kernel queued before it: a read of the card (`.cpu()`, `float(t)`)
and an upload alike.

`timed(name)` is a span that always stamps its start and end, for the
totals a caller keeps itself (`utils.Timer`, `cli/transcribe.py`'s
`stages`); it records like `span` only while recording is on.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18
COUNTERS = ("host_waits", "h2d_bytes", "d2h_bytes", "tables_built", "tables_reused",
            "conv_tunes")

_force: bool | None = None  # None: record while a torch profiler runs
_tls = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_lock = threading.Lock()
_kept: list = []
_dropped = 0
_KERNELS = __package__ + ".hmm.viterbi_dense"
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def recording() -> bool:
    """Whether spans record now."""
    return _profiler._is_profiler_enabled if _force is None else _force


@contextlib.contextmanager
def enabled(on: bool = True):
    """Spans record inside (on=True) with or without a profiler, or not at
    all (on=False) even under one."""
    global _force
    prev, _force = _force, bool(on)
    try:
        yield
    finally:
        _force = prev


@contextlib.contextmanager
def request():
    """The root spans this thread opens inside share one request id (the
    enclosing request's, where there is one), so that several API calls
    count as one request."""
    prev = getattr(_tls, "request", None)
    _tls.request = prev or next(_requests)
    try:
        yield _tls.request
    finally:
        _tls.request = prev


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _launch_counts():
    kernels = sys.modules.get(_KERNELS)
    if kernels is None:
        return None
    return {k: w.launches for k, w in kernels.KERNEL_WRAPPERS.items()}


def _annotation(name: str):
    if _RecordFunctionFast is not None:
        return _RecordFunctionFast(name)
    return _profiler.record_function(name)


def _flat(d: dict) -> tuple:
    return tuple(itertools.chain.from_iterable(d.items()))


def _dict(flat: tuple) -> dict:
    return dict(zip(flat[::2], flat[1::2]))


def _keep(span) -> None:
    global _dropped
    record = (span.name, span.id, span.parent, span.request, span.start, span.end,
              _flat(span.attrs), _flat(span.counts))
    with _lock:
        if len(_kept) < CAPACITY:
            _kept.append(record)
        else:
            _dropped += 1


class Record(NamedTuple):
    """A closed span, as `spans()` returns it."""

    name: str
    id: int
    parent: int | None
    request: int
    start: int
    end: int
    attrs: dict
    counts: dict


class Span:
    """An open span (entered as a context)."""

    __slots__ = ("name", "id", "parent", "request", "start", "end", "attrs", "counts",
                 "_on", "_rf", "_launches")

    def __init__(self, name: str, attrs: dict, on: bool | None):
        self.name, self.attrs, self.counts = name, attrs, {}
        self.id = self.parent = self.request = self.start = self.end = None
        self._on, self._rf, self._launches = on, None, None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        if self._on is None:
            self._on = recording()
        if self._on:
            stack = _stack()
            if stack:
                self.parent, self.request = stack[-1].id, stack[-1].request
            else:
                self.request = getattr(_tls, "request", None) or next(_requests)
                self._launches = _launch_counts()
            self.id = next(_ids)
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._rf = _annotation(self.name)
                self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self._on:
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            if self._launches is not None:
                after = _launch_counts() or {}
                self.attrs["launches"] = _flat({k: n - self._launches.get(k, 0) for k, n in
                                                after.items() if n != self._launches.get(k, 0)})
                self._launches = None
            _keep(self)
        return False


class _Off:
    """The shared no-op span of a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A span named `name` with `attrs` while recording is on, else the
    shared no-op context (falsy, so `if sp:` guards work done only for its
    attrs)."""
    if not (_profiler._is_profiler_enabled if _force is None else _force):
        return _OFF
    return Span(name, attrs, True)


def timed(name: str, **attrs) -> Span:
    """A span that always stamps its start and end (`.seconds`); it records
    only while recording is on."""
    return Span(name, attrs, None)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span (none: nothing)."""
    if not (_profiler._is_profiler_enabled if _force is None else _force):
        return
    stack = _stack()
    if stack and n:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def wait(layer: str):
    """A blocking read of the card: a `<layer>.wait` span counting one
    host_waits."""
    if not (_profiler._is_profiler_enabled if _force is None else _force):
        return _OFF
    sp = Span(f"{layer}.wait", {}, True)
    sp.counts["host_waits"] = 1
    return sp


def to_host(t: torch.Tensor, layer: str) -> torch.Tensor:
    """t.cpu(). From a card it is a blocking read: a `<layer>.wait` span,
    its bytes counted as d2h_bytes."""
    if t.device.type == "cpu":
        return t
    with wait(layer):
        count("d2h_bytes", t.nbytes)
        return t.cpu()


def upload(x, device, layer: str, dtype=None) -> torch.Tensor:
    """x (a tensor, an array or a number) as a tensor of `dtype` on `device`:
    `x.to(device, dtype)`, or `torch.tensor(x, dtype, device)` (a copy). From
    the host to a card it is a blocking copy: a `<layer>.wait` span, its
    bytes counted as h2d_bytes."""
    device = torch.device(device)
    tensor = isinstance(x, torch.Tensor)

    def copy():
        return x.to(device=device, dtype=dtype) if tensor else torch.tensor(x, dtype=dtype,
                                                                           device=device)

    if device.type == "cpu" or (tensor and x.device.type != "cpu"):
        return copy()
    with wait(layer):
        out = copy()
        count("h2d_bytes", out.nbytes)
        return out


def spans() -> list[Record]:
    """The kept spans, in the order they closed."""
    with _lock:
        records = [Record(*r[:6], _dict(r[6]), _dict(r[7])) for r in _kept]
    for r in records:
        if "launches" in r.attrs:
            r.attrs["launches"] = _dict(r.attrs["launches"])
    return records


def dropped() -> int:
    """Spans closed while the buffer was full, and not kept."""
    return _dropped


def clear() -> None:
    """Empty the buffer and its dropped count."""
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0
