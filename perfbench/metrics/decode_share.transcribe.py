"""Share of the window in the decode service: the benchmark's spans around
DecoderSetup.decode_batch, each ending in a synchronise."""


def read(run):
    return run.span_share("decode")
