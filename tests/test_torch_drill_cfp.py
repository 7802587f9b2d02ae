"""The real-data drill of tests/test_torch_drill.py (its docstring gives
the chain and the checks) for ftanet at its app width (wav -> CFP ->
FTANet), in a file of its own so that the test workers share the
drills."""

from test_torch_drill import drill, fake_corpus  # noqa: F401 (fixtures)
from torch_threads import one_thread  # noqa: F401 (fixture)


def test_ftanet_real_data_chain(fake_corpus, tmp_path, monkeypatch):  # noqa: F811
    from viterbi_spl_tpu_torch.apps import ftanet

    drill(ftanet, fake_corpus, tmp_path, monkeypatch)
