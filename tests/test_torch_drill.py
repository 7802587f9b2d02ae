"""The port's real-data chains on the fake corpus (data/fake_corpus.py), on
the CPU: the counterpart of tests/test_fake_corpus.py's drill.

Each family's app trains one step at --debug size on the fake MedleyDB
(wav -> front-end -> model -> loss), checkpoints, then infers with
--external-eval over the validation and test splits and the four external
corpora (adc04, mirex05, mir1k, rwc): wav/aiff -> front-end -> model ->
HMM decode -> metrics. The drill holds the JAX drill's checks: every eval
set present with finite raw and Viterbi OAs, and the accumulated OA
against the mir_eval-semantics score (cross_check_diff_viterbi) within
1e-6 where the family's estimate grid is the corpus's annotation timebase
(msnet and dcnet on the 256-hop grid: medleydb and adc04) and within 0.05
elsewhere, where the mir_eval path resamples the estimate onto the
original times (the reference prints these diffs,
dcnet/softmax_viterbi.py:3504-3531).

This file: msnet (strict on validation, test and adc04). The others, a
file each so that the test workers share them: tests/test_torch_drill_jdc.py,
tests/test_torch_drill_cfp.py (ftanet), tests/test_torch_drill_tonet.py
(TONet at attn_dim 32, as tests/test_torch_apps_cfp.py), and
tests/test_torch_drill_44k.py (dcnet, and imm's eval with --external-eval
--original --calibrate-threshold held to the JAX app's).
"""

import numpy as np
import pytest
import torch

from viterbi_spl_tpu_torch.data import generate_fake_corpus

EVAL_SETS = ("validation", "test", "adc04", "mirex05", "mir1k", "rwc")
STRICT_TOL, LOOSE_TOL = 1e-6, 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread: under pytest-xdist each worker's PyTorch would
    spread its ops over every core, and with six workers their threads'
    waits multiplied these tests' time five- to tenfold (measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_corpus(tmp_path_factory):
    return generate_fake_corpus(tmp_path_factory.mktemp("corpus"), duration=2.0, device="cpu")


def drill(app_module, fake_corpus, tmp_path, monkeypatch, strict=()):
    """train --debug one step, then infer --debug --external-eval; the JAX
    drill's checks (module docstring)."""
    for k, v in fake_corpus.items():
        monkeypatch.setenv(k, v)
    common = ["--debug", "--device", "cpu", "--ckpt", str(tmp_path / "ck.pt")]
    state = app_module.main(["train", *common, "--epochs", "1", "--steps-per-epoch", "1",
                             "--patience", "1"])
    assert np.isfinite(state.best_oa) and state.step == 1
    out = app_module.main(["infer", *common, "--external-eval"])
    assert [k for k in out if k != "state"] == list(EVAL_SETS)
    for corpus in EVAL_SETS:
        res = out[corpus]
        assert np.isfinite(res["viterbi_mean_oa"]) and np.isfinite(res["raw_mean_oa"]), corpus
        assert len(res["viterbi"]["oa"]) == 2, corpus
        tol = STRICT_TOL if corpus in strict else LOOSE_TOL
        assert max(abs(d) for d in res["cross_check_diff_viterbi"]) < tol, corpus
    return out


def test_msnet_real_data_chain(fake_corpus, tmp_path, monkeypatch):
    from viterbi_spl_tpu_torch.apps import msnet

    # msnet estimates on the 256-hop grid, the medleydb/adc04 annotation
    # timebase, so the cross-check is exact there
    drill(msnet, fake_corpus, tmp_path, monkeypatch, strict=("validation", "test", "adc04"))
