"""The port's fake corpus (viterbi_spl_tpu_torch/data/fake_corpus.py), its
AIFF reader (io/wav.py) and tonet's MedleyDB datasets on it against the
JAX package's, on the CPU.

Tolerances:
- the generator: every file of both trees equal, byte for byte, for the
  same arguments (the port sizes the annotations with its own CFP, on the
  CPU here; a frame count depends only on a signal's length);
- the AIFF readers (load_aiff through the stdlib aifc, and the raw
  FORM/COMM/SSND parser): the same samples, bit for bit, and the same rate
  (both sides are NumPy);
- tonet's datasets (build_real_datasets, m2m3 and yu labels): the same
  track ids, shapes and notes (exact); the features within 3.5e-3 of a
  part's maximum, the JAX package's float32 CFP block's error against
  float64 on a plain tone (tests/test_torch_frontend.py's docstring,
  scripts/precision_probe.py; the port's chain is float64).
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.apps import tonet as JT
from viterbi_spl_tpu.data.fake_corpus import generate_fake_corpus as j_generate
from viterbi_spl_tpu.io import wav as JW
from viterbi_spl_tpu_torch.apps import tonet as TT
from viterbi_spl_tpu_torch.data import generate_fake_corpus
from viterbi_spl_tpu_torch.io import wav as TW

CFP_TOL = 3.5e-3


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The default 2 s corpus from both generators."""
    root = tmp_path_factory.mktemp("corpus")
    return (generate_fake_corpus(root / "t", duration=2.0, device="cpu"),
            j_generate(root / "j", duration=2.0), root)


@pytest.mark.parametrize("kw", [None, dict(duration=0.5, ext_duration=0.6, rwc_duration=0.4,
                                           hard=True)], ids=["default", "hard"])
def test_fake_corpus_matches_jax_byte_for_byte(corpora, tmp_path, kw):
    """The module's 2 s corpus, and a short one of the hard regime (rich
    melodies, tremolo, accompaniment, noise) with its own external and RWC
    durations."""
    if kw is None:
        got_roots, want_roots, root = corpora
        got, want = tree(root / "t"), tree(root / "j")
    else:
        got_roots = generate_fake_corpus(tmp_path / "t", **kw, device="cpu")
        want_roots = j_generate(tmp_path / "j", **kw)
        got, want = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert sorted(got_roots) == sorted(want_roots)
    assert list(got) == list(want) and len(got) == 138
    bad = [name for name in got if got[name] != want[name]]
    assert not bad, bad[:5]
    assert sum(name.endswith(".aiff") for name in got) == 100
    assert sum(name.startswith("fatnet/f0ref/") for name in got) == 6


def _aiff_files(corpora):
    rwc = Path(corpora[0]["rwc"]) / "popular"
    return sorted(rwc.glob("RWC-MDB-P-2001-M01/*.aiff"))[:3]


@pytest.mark.parametrize("mono", [True, False])
def test_load_aiff_matches_jax_on_fake_rwc(corpora, mono):
    """The fake RWC recordings (two of real audio, one of the 256-sample
    filler), through both readers of both packages."""
    for path in _aiff_files(corpora):
        want, sr = JW.load_aiff(path, mono)
        assert sr == 44100 and want.dtype == np.float32
        for loader in (TW.load_aiff, TW._load_aiff_raw):
            got, got_sr = loader(path, mono)
            assert got_sr == sr and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TW._load_aiff_raw(path, mono)[0],
                                      JW._load_aiff_raw(path, mono)[0])


def _write_aiff(path: Path, ints: np.ndarray, width: int, sr: int, aifc_form: bool) -> None:
    """Big-endian PCM of `width` bytes through the stdlib writer: AIFF, or
    the AIFC form (compression NONE)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc

    raw = ints.astype(">i4").view(np.uint8).reshape(-1, 4)[:, 4 - width:].tobytes()
    with aifc.open(str(path), "wb") as fh:
        if aifc_form:
            fh.aifc()
        else:
            fh.aiff()
        fh.setnchannels(ints.shape[1])
        fh.setsampwidth(width)
        fh.setframerate(sr)
        fh.writeframes(raw)


@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("aifc_form", [False, True], ids=["aiff", "aifc"])
def test_load_aiff_widths_match_jax(tmp_path, rng, width, channels, aifc_form):
    """16-, 24- and 32-bit PCM, mono and stereo, AIFF and AIFC, with and
    without the channel mean: the port's readers give the JAX package's
    samples and rate, and the samples are the written integers scaled."""
    bits = 8 * width
    # an even byte count: the stdlib writer counts an odd SSND chunk's pad
    # byte in its size, which both packages' raw parsers then read as data
    ints = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), (1000, channels))
    path = tmp_path / f"w{width}c{channels}.{'aifc' if aifc_form else 'aiff'}"
    _write_aiff(path, ints, width, 22050, aifc_form)
    exact = (ints / float(2 ** (bits - 1))).astype(np.float32)
    for mono in (True, False):
        want, sr = JW.load_aiff(path, mono)
        assert sr == 22050
        for loader in (TW.load_aiff, TW._load_aiff_raw):
            got, got_sr = loader(path, mono)
            assert got_sr == sr
            np.testing.assert_array_equal(got, want)
        if not mono and channels == 2:
            np.testing.assert_array_equal(want, exact)
        elif channels == 1:
            np.testing.assert_array_equal(want, exact[:, 0])


def test_load_aiff_without_aifc(corpora, monkeypatch):
    """Where the stdlib aifc is gone (Python 3.13), load_aiff takes the raw
    parser and still gives the JAX package's samples."""
    import sys

    monkeypatch.setitem(sys.modules, "aifc", None)
    for path in _aiff_files(corpora):
        got, sr = TW.load_aiff(path)
        want, want_sr = JW._load_aiff_raw(path, True)
        assert sr == want_sr == 44100
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("labels", ["m2m3", "yu"])
def test_tonet_real_datasets_match_jax(corpora, monkeypatch, labels):
    """tonet's MedleyDB splits on the fake corpus (the wav -> tonet CFP
    chain, and the MELODY2 + vocal-section labels or the precomputed
    $fatnet_spec/f0ref ones), as the JAX package's build_real_datasets
    (tests/test_fake_corpus.py:112 for yu)."""
    for k, v in corpora[0].items():
        monkeypatch.setenv(k, v)
    got = TT.build_real_datasets(debug=True, device="cpu", labels=labels)
    want = JT.build_real_datasets(debug=True, labels=labels)
    assert list(got) == list(want) == ["training", "validation", "test"]
    for split in got:
        assert got[split].track_ids == want[split].track_ids and len(got[split]) == 2
        for g, w in zip(got[split].tracks, want[split].tracks):
            assert g.spectrogram.shape == w.spectrogram.shape
            assert g.spectrogram.shape[1:] == (3, 360)
            np.testing.assert_array_equal(g.notes, w.notes)
            assert len(g.notes) == g.num_frames and (g.notes >= 0).all()
            np.testing.assert_array_equal(g.original_times, w.original_times)
            np.testing.assert_array_equal(g.original_freqs, w.original_freqs)
            scale = np.abs(w.spectrogram).max(axis=(0, 2))  # a part's maximum
            err = np.abs(g.spectrogram - w.spectrogram).max(axis=(0, 2))
            assert (err <= CFP_TOL * scale).all(), err / scale
