"""Device time of the operations launched inside the program's spans of one
name, for the readers of the metrics built on it."""

from perfbench.metrics._program import window_spans


def launched_share(run, name: str):
    """Percent of the traced window that the card spends on the operations
    whose CUDA runtime call (launch or copy) the host made inside the
    program's spans `name` (Trace.launched_in); None without such spans."""
    inside = [(s.start, s.end) for s in window_spans(run) or () if s.name == name]
    if not inside:
        return None
    return 100.0 * run.trace.launched_in(inside) / run.trace.window_s
