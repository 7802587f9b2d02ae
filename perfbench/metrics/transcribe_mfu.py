"""TONet's forward FLOPs over the window's real frames (padding not
counted), over the traced window and the float32 peak (67 TFLOP/s)."""

from perfbench.work import FP32_OPS_PER_S


def read(run):
    if run.trace is None:
        return None
    flops = run.extra["flops_per_frame"] * run.extra["frames"]
    return 100.0 * flops / run.trace.window_s / FP32_OPS_PER_S
