"""Share of the window in which the card is idle while the host is inside
the program's `model` spans (apps.common.model_logits_for_dataset)."""

from perfbench.metrics._program import idle_share_in


def read(run):
    return idle_share_in(run, "model")
