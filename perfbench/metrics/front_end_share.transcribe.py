"""Share of the window in the front-end: the benchmark's spans around
cli.transcribe.features_from_samples, each ending in a synchronise."""


def read(run):
    return run.span_share("front_end")
