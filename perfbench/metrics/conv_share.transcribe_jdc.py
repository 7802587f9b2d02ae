"""Share of the traced window that the card spends on the operations
launched inside the program's `model.convs` spans (models/jdc.py: the
first conv to the pooled block 4)."""

from perfbench.metrics._launched import launched_share


def read(run):
    return launched_share(run, "model.convs")
