"""Transition tables a decode request builds on the host: the program's
tables_built counter (one for each decode.prepare that built them)."""

from perfbench.metrics._program import a_request


def read(run):
    return a_request(run, "tables_built")
