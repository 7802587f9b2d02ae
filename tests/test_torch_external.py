"""The port's external evaluation corpora (apps/common.py::
build_external_eval_datasets and each family's build_external_datasets)
against the JAX package's, on the fake corpus (data/fake_corpus.py), on the
CPU.

Tolerances:
- build_external_eval_datasets with one shared NumPy feature (a plain
  framing of the samples, so that no front-end is compared): equal, value
  for value — track ids, features, notes (the 10 ms resampling included),
  original times and freqs, and the lengths after padding and trimming;
- each family's front-end (its build_external_datasets, the port on the
  CPU): track ids, notes, original times and freqs equal; the features
  within the tolerance its front-end is held to against the JAX package's
  float32 one (the port's chains run in float64):
  - the 8 kHz CFPs (ftanet, tonet): 3.5e-3 of a part's maximum, the JAX
    float32 block's error against float64 on a plain tone
    (tests/test_torch_frontend.py's docstring, scripts/precision_probe.py);
  - msnet's 44.1 kHz CFP: 2e-2 of a part's maximum, the bound
    tests/test_torch_frontend.py::test_cfp_block_matches_oracle_and_jax
    holds the MSNET_CFP block to (measured here up to 7.8e-3, on mir1k's
    16 kHz audio resampled to 44.1 kHz: the empty band above 8 kHz sits
    at the spectrum's floor, where float32 rounding is a large relative
    error);
  - the jdc spectrogram: 0.024 of its range, the JAX package's float32
    error on a plain tone (tests/test_torch_frontend.py's docstring);
  - dcnet's NSGT feature: 5e-4 (its range is [0, 1]). tests/test_torch_nsgt.py
    holds 1e-4 on noise; the fake corpus's tones put many bins at the
    feature's amplitude floor (1e-5), where one float32 rounding of the
    largest magnitude (~0.45 x 2^-24) is 2e-4 of the feature's 120 dB
    scale; measured here up to 1.2e-4.
"""

import importlib

import numpy as np
import pytest

from test_torch_drill import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.apps import common as JC
from viterbi_spl_tpu_torch.apps import common as TC
from viterbi_spl_tpu_torch.data import generate_fake_corpus

CORPORA = ("adc04", "mirex05", "mir1k", "rwc")
# (feature tolerance, the axes over which a part's maximum is taken)
FEATURE_TOL = dict(msnet=(2e-2, (0, 1)), ftanet=(3.5e-3, (0, 1)), tonet=(3.5e-3, (0, 2)),
                   jdc=(0.024, None), dcnet=(5e-4, None))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return generate_fake_corpus(tmp_path_factory.mktemp("corpus"), duration=2.0, device="cpu")


@pytest.fixture
def corpus_env(roots, monkeypatch):
    for k, v in roots.items():
        monkeypatch.setenv(k, v)
    return roots


def framing(hop):
    """The shared NumPy feature: the samples cut into hop-long frames (the
    last one zero-padded)."""
    def spec_fn(samples):
        x = np.asarray(samples, np.float32)
        return np.pad(x, (0, -len(x) % hop)).reshape(-1, hop)

    return spec_fn


def assert_same_datasets(got, want, tol=None, axes=None):
    assert list(got) == list(want)
    for name in got:
        g_ds, w_ds = got[name], want[name]
        assert g_ds.track_ids == w_ds.track_ids and len(g_ds) == len(w_ds) > 0, name
        for g, w in zip(g_ds.tracks, w_ds.tracks):
            what = f"{name}/{g.track_id}"
            assert g.spectrogram.shape == w.spectrogram.shape, what
            np.testing.assert_array_equal(g.notes, w.notes, err_msg=what)
            np.testing.assert_array_equal(g.original_times, w.original_times, err_msg=what)
            np.testing.assert_array_equal(g.original_freqs, w.original_freqs, err_msg=what)
            if tol is None:
                np.testing.assert_array_equal(g.spectrogram, w.spectrogram, err_msg=what)
            elif axes is None:
                span = w.spectrogram.max() - w.spectrogram.min()
                assert np.abs(g.spectrogram - w.spectrogram).max() <= tol * span, what
            else:
                err = np.abs(g.spectrogram - w.spectrogram).max(axis=axes)
                assert (err <= tol * np.abs(w.spectrogram).max(axis=axes)).all(), what


@pytest.mark.parametrize("labels_on_10ms,corpora,debug", [
    (False, None, True), (True, None, True), (False, ("mirex05", "rwc"), True),
    (True, ("adc04", "mir1k"), True), (False, ("mir1k",), False)])
def test_external_eval_datasets_match_jax(corpus_env, labels_on_10ms, corpora, debug):
    """All four corpora (mir1k's label length from its wav header, rwc
    through the 7-disk walk and load_aiff, resampled by the gcd at 8 kHz),
    the 256-hop grid at 44.1 kHz and the 10 ms one at 8 kHz, mirex05's,
    mir1k's and rwc's padded notes, the corpora= filter and --debug's two
    tracks (mir1k's ids are the files present, so it also runs whole)."""
    sr, hop = (8000, 80) if labels_on_10ms else (44100, 256)
    kw = dict(sr=sr, labels_on_10ms=labels_on_10ms, debug=debug, corpora=corpora)
    got = TC.build_external_eval_datasets(framing(hop), **kw)
    want = JC.build_external_eval_datasets(framing(hop), **kw)
    assert list(got) == [c for c in CORPORA if corpora is None or c in corpora]
    assert_same_datasets(got, want)


def test_external_eval_datasets_without_roots(monkeypatch):
    """No corpus root set: no dataset in either package."""
    for name in CORPORA:
        monkeypatch.delenv(name, raising=False)
    assert TC.build_external_eval_datasets(framing(256), sr=44100) == {} == \
        JC.build_external_eval_datasets(framing(256), sr=44100)


@pytest.mark.parametrize("fam", ["msnet", "ftanet", "tonet", "jdc", "dcnet"])
def test_family_external_datasets_match_jax(corpus_env, fam):
    """Each family's build_external_datasets(debug=True): its front-end at
    its sample rate (features_from_samples, the chain a transcribed wav
    takes), 10 ms labels for ftanet, jdc and tonet, tonet's [T, 3, 360]."""
    got = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{fam}").build_external_datasets(
        debug=True, device="cpu")
    want = importlib.import_module(f"viterbi_spl_tpu.apps.{fam}").build_external_datasets(
        debug=True)
    assert list(got) == list(CORPORA)
    assert_same_datasets(got, want, *FEATURE_TOL[fam])
    if fam == "tonet":
        assert got["adc04"][0].spectrogram.shape[1:] == (3, 360)
