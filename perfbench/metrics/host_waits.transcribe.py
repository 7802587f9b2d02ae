"""Blocking copies between the host and the card a clip: the program's
host_waits counter, summed over its spans."""

from perfbench.metrics._program import a_clip


def read(run):
    return a_clip(run, ("host_waits",))
