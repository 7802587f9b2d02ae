"""Share of the window in which the card is idle while the host is inside
the program's `decode` spans (the decode API)."""

from perfbench.metrics._program import idle_share_in


def read(run):
    return idle_share_in(run, "decode")
