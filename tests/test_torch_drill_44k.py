"""The real-data chains of the 44.1 kHz families on the fake corpus: the
drill of tests/test_torch_drill.py (its docstring gives the chain and the
checks) for dcnet at its app width (wav -> NSGT -> DCNet), and imm's eval
over MedleyDB and the external corpora, held to the JAX app's; in a file
of their own so that the test workers share the drills."""

import numpy as np
import pytest

from test_torch_drill import drill, fake_corpus  # noqa: F401 (fixtures)
from torch_threads import one_thread  # noqa: F401 (fixture)


def test_dcnet_real_data_chain(fake_corpus, tmp_path, monkeypatch):  # noqa: F811
    """The NSGT chain; dcnet estimates on the 256-hop grid like msnet, so
    the medleydb and adc04 cross-checks are exact."""
    from viterbi_spl_tpu_torch.apps import dcnet

    drill(dcnet, fake_corpus, tmp_path, monkeypatch, strict=("validation", "test", "adc04"))


def test_imm_real_data_chain(fake_corpus, monkeypatch):  # noqa: F811
    """imm on the fake corpus (tests/test_fake_corpus.py:132-167): MedleyDB
    test wavs -> sinebell STFT -> NMF fit -> log-energy logits ->
    thresholding and Viterbi evaluation, the 'original' method (HF0 +
    analytic transition + cumulative-energy voicing), the threshold
    calibration, and adc04, mirex05 and mir1k with all three methods, not
    rwc (imm/main_imm.py). The port's NMF starts from the JAX package's
    draws (test_torch_imm.patch_fits_to_jax_draws), so that its OAs and
    calibration are held to the JAX app's on the same corpus, within 1e-6
    as tests/test_torch_imm_app.py holds the synthetic ones."""
    from test_torch_imm import patch_fits_to_jax_draws
    from viterbi_spl_tpu.apps import imm as j_imm
    from viterbi_spl_tpu_torch.apps import imm

    for k, v in fake_corpus.items():
        monkeypatch.setenv(k, v)
    patch_fits_to_jax_draws(monkeypatch)
    argv = ["eval", "--debug", "--external-eval", "--original", "--calibrate-threshold"]
    out = imm.main(argv + ["--device", "cpu"])
    want = j_imm.main(argv)
    assert np.isfinite(out["viterbi_mean_oa"]) and np.isfinite(out["raw_mean_oa"])
    assert np.isfinite(out["original"]["mean_oa"])
    for corpus in (None, "adc04", "mirex05", "mir1k"):
        got_c, want_c = (out, want) if corpus is None else (out[corpus], want[corpus])
        for key in ("raw_mean_oa", "viterbi_mean_oa"):
            assert np.isfinite(got_c[key]), (corpus, key)
            assert got_c[key] == pytest.approx(want_c[key], abs=1e-6), (corpus, key)
        assert len(got_c["original"]["oas"]) == 2, corpus
        assert got_c["original"]["oas"] == pytest.approx(want_c["original"]["oas"], abs=1e-6)
    assert "rwc" not in out and sorted(out) == sorted(want)
    cal = out["calibration"]
    assert len(cal["thresholds"]) == 99 and np.isfinite(cal["best_threshold"])
    assert cal["thresholds"][0] <= cal["best_threshold"] <= cal["thresholds"][-1]
    assert np.isclose(cal["thresholds"][91], 2.442347, atol=1e-4)
    assert cal["best_threshold"] == want["calibration"]["best_threshold"]
    np.testing.assert_array_equal(cal["va"], want["calibration"]["va"])
