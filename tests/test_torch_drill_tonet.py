"""The real-data drill of tests/test_torch_drill.py (its docstring gives
the chain and the checks) for TONet at attn_dim 32, as
tests/test_torch_apps_cfp.py runs it, in a file of its own so that the
test workers share the drills."""

import dataclasses

from test_torch_drill import drill, fake_corpus, one_thread  # noqa: F401 (fixtures)


def test_tonet_real_data_chain(fake_corpus, tmp_path, monkeypatch):  # noqa: F811
    """[T, 3, 360] tonet-CFP layout, the dual-backbone model and the
    warm-up/decay schedule, 10 ms labels."""
    from viterbi_spl_tpu_torch.apps import tonet
    from viterbi_spl_tpu_torch.models.tonet import TONet

    wide = tonet.config
    monkeypatch.setattr(tonet, "config", lambda: dataclasses.replace(
        wide(), make_model=lambda **kw: TONet(**{"attn_dim": 32, **kw})))
    drill(tonet, fake_corpus, tmp_path, monkeypatch)
