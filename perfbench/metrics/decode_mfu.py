"""The least time of every decode in the window (work.decode_bound: logits
read and states written once over 3.35 TB/s, or the observation model's,
forward DP's and backtrace's operations over 67 TFLOP/s, the larger), over
the traced window. The same work whatever kernels implement it."""


def read(run):
    if run.trace is None or not run.records:
        return None
    return 100.0 * sum(r["decode_s"] for r in run.records) / run.trace.window_s
