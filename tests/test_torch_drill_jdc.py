"""The real-data drill of tests/test_torch_drill.py (its docstring gives
the chain and the checks) for jdc at its app width (wav -> STFT -> JDC),
in a file of its own so that the test workers share the drills."""

from test_torch_drill import drill, fake_corpus, one_thread  # noqa: F401 (fixtures)


def test_jdc_real_data_chain(fake_corpus, tmp_path, monkeypatch):  # noqa: F811
    from viterbi_spl_tpu_torch.apps import jdc

    # jdc estimates on the 10 ms grid: no corpus's annotation is on it
    drill(jdc, fake_corpus, tmp_path, monkeypatch)
