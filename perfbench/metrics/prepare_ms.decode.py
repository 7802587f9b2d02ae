"""Mean host time a decode request spends in the program's `decode.prepare`
spans: the transition tables built on the host (extract_banded_structure,
prepare_log_params) on every call."""

from perfbench.metrics._program import ms_a_request


def read(run):
    return ms_a_request(run, "decode.prepare")
