"""Mean host time a request spends from the call into the decode API to its
first kernel's start on the device, read from the profiler's timeline."""

import bisect


def read(run):
    t = run.trace
    if t is None:
        return None
    starts = sorted(s for n, s, e, _ in t.device if not n.startswith(("Memcpy", "Memset")))
    waits = []
    for s, e in t.spans("request"):
        i = bisect.bisect_left(starts, s)
        if i < len(starts) and starts[i] <= e:
            waits.append((starts[i] - s) / 1e6)
    return sum(waits) / len(waits) if waits else None
