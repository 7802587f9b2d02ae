"""The least time of the observation model and the forward DP of every
request in the window (work.fused_forward_bound), over the device time of
the kernels this metric's data names (K9 today; K5 and K1 if the route
changes)."""

from perfbench.harness import metric_data


def read(run):
    if run.trace is None or not run.records:
        return None
    busy = run.trace.seconds(metric_data("forward_roofline.decode")["kernels"])
    return 100.0 * sum(r["forward_s"] for r in run.records) / busy if busy else None
