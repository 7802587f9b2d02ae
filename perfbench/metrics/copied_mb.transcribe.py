"""Megabytes (1e6 bytes) copied between the host and the card a clip: the
program's h2d_bytes and d2h_bytes counters, summed over its spans."""

from perfbench.metrics._program import a_clip


def read(run):
    value = a_clip(run, ("h2d_bytes", "d2h_bytes"))
    return None if value is None else value / 1e6
