"""Share of the traced window that the card spends on the operations
launched inside the program's `model.recurrent` spans (models/jdc.py: each
BiLSTM, pitch and voicing heads)."""

from perfbench.metrics._launched import launched_share


def read(run):
    return launched_share(run, "model.recurrent")
