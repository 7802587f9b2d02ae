"""Mean host time a decode request spends in the program's `decode.wait`
spans: the blocking copies between the host and the card inside the decode
API, where the host waits for the kernels queued before them."""

from perfbench.metrics._program import ms_a_request


def read(run):
    return ms_a_request(run, "decode.wait")
