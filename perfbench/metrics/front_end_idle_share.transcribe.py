"""Share of the window in which the card is idle while the host is inside
the program's `front_end` spans (cli.transcribe.features_from_samples)."""

from perfbench.metrics._program import idle_share_in


def read(run):
    return idle_share_in(run, "front_end")
