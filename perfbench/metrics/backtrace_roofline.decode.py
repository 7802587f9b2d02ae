"""The least time of the backtrace of every request in the window
(work.backtrace_work: a t1m1 row a step read, the states written), over the
device time of the kernels this metric's data names (K2 by either route;
K4 if the route changes)."""

from perfbench.harness import metric_data


def read(run):
    if run.trace is None or not run.records:
        return None
    busy = run.trace.seconds(metric_data("backtrace_roofline.decode")["kernels"])
    return 100.0 * sum(r["backtrace_s"] for r in run.records) / busy if busy else None
