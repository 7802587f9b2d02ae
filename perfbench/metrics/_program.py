"""The program's own spans (viterbi_spl_tpu_torch/tracing.py) in a traced
run, for the readers of the metrics built on them.

A span is kept when it starts inside the traced window. A program without
the tracer, a window the program recorded no span in, or a buffer that
dropped spans gives None.
"""

from __future__ import annotations


def window_spans(run):
    """The program's spans that start inside run.trace's window, or None."""
    t = run.trace
    if t is None:
        return None
    try:
        from viterbi_spl_tpu_torch import tracing
    except ImportError:
        return None
    if tracing.dropped():
        return None
    kept = [s for s in tracing.spans() if t.start <= s.start <= t.end]
    return kept or None


def ms_a_request(run, name: str):
    """Mean over the window's requests (the request ids of its spans) of
    the host milliseconds in their spans `name` (0 for a request with
    none); None where the window has no span `name`."""
    spans = window_spans(run)
    named = [s for s in spans or () if s.name == name]
    if not named:
        return None
    return sum(s.end - s.start for s in named) / 1e6 / len({s.request for s in spans})


def a_request(run, counter: str):
    """The counter summed over the window's spans, over its requests (the
    request ids of its spans); None without spans."""
    spans = window_spans(run)
    if spans is None:
        return None
    return sum(s.counts.get(counter, 0) for s in spans) / len({s.request for s in spans})


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b) -> int:
    """Length shared by two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(run, name: str):
    """Percent of the window in which the card is idle (no device
    operation: the complement of run.trace.busy) while the host is inside
    a span `name`; None without such spans."""
    spans = window_spans(run)
    if spans is None:
        return None
    t = run.trace
    inside = _union((max(s.start, t.start), min(s.end, t.end)) for s in spans if s.name == name)
    if not inside:
        return None
    idle = sum(e - s for s, e in inside) - _overlap(inside, t.busy)
    return 100.0 * idle / (t.end - t.start)


def a_clip(run, counters):
    """The counters `counters` summed over the window's spans, over the
    clips the window served (run.records); None where no span counted
    them."""
    spans = window_spans(run)
    counted = [s.counts[c] for s in spans or () for c in counters if c in s.counts]
    if not counted or not run.records:
        return None
    return sum(counted) / len(run.records)
