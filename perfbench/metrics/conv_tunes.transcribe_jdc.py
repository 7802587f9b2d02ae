"""Input shapes JDC's conv stack meets for the first time in the process, a
request: the program's conv_tunes counter (models/jdc.py; on the card cuDNN
measures its algorithms for such a shape). 0 where set-up met every shape
the window runs. None for a program without the counter."""

from perfbench.metrics._program import a_request


def read(run):
    try:
        from viterbi_spl_tpu_torch import tracing
    except ImportError:
        return None
    if "conv_tunes" not in getattr(tracing, "COUNTERS", ()):
        return None
    return a_request(run, "conv_tunes")
