"""Share of the window in the model: the benchmark's spans around
apps.common.model_logits_for_dataset, each ending in a synchronise."""


def read(run):
    return run.span_share("model")
