"""The port's decode service end to end against the JAX package: .dat
artifacts, DecoderSetup, evaluate_posteriorgrams and the decode CLI, on
the CPU (`device="cpu"`); plus the import boundary and the device rule."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_hmm
from viterbi_spl_tpu.cli import decode as JD
from viterbi_spl_tpu.cli.hmm_artifacts import build_hmm_artifacts as jax_build
from viterbi_spl_tpu.families import family_spec as jax_family_spec
from viterbi_spl_tpu.harness import evaluate as JE
from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.io import array_file as JA
from viterbi_spl_tpu_torch.cli import decode as TD
from viterbi_spl_tpu_torch.cli.hmm_artifacts import (
    build_hmm_artifacts,
    load_hmm_artifacts,
    quantize_tracks_for_family,
)
from viterbi_spl_tpu_torch.families import FAMILIES, family_spec
from viterbi_spl_tpu_torch.harness import evaluate as TE
from viterbi_spl_tpu_torch.io import array_file as TA
from viterbi_spl_tpu_torch.metrics.mel_eval import midi_to_hz

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = ("transition_int.dat", "p_steady.dat", "switch.dat",
             "viterbi_transition_matrix.dat", "viterbi_init_probs.dat")
METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")
HZ_ATOL, HZ_RTOL = 1e-4, 1e-6


def _bin_track(rng, n_bins, n=3000):
    walk = np.clip(n_bins // 2 + np.cumsum(rng.integers(-2, 3, n)), 0, n_bins - 1)
    voiced = np.repeat(rng.random(n // 20 + 1) > 0.3, 20)[:n]
    return np.where(voiced, walk, n_bins)


def _logits(rng, n_bins, T):
    """A clear melody line over noise: tie-free peaks."""
    logits = rng.normal(-2, 1, (T, n_bins)).astype(np.float32)
    path = np.clip(n_bins // 2 + np.cumsum(rng.integers(-1, 2, T)), 0, n_bins - 1)
    logits[np.arange(T), path] += 6.0
    return logits


def test_dat_round_trips_bitwise(tmp_path, rng):
    arrays = [
        rng.random((5, 7)).astype(np.float32),
        np.asfortranarray(rng.random((4, 3))),
        rng.integers(0, 9, (6,)).astype(np.int64),
        rng.random((3, 4, 2))[:, ::2],  # neither C nor F contiguous
    ]
    for i, a in enumerate(arrays):
        pt, pj = tmp_path / f"t{i}.dat", tmp_path / f"j{i}.dat"
        TA.save_array(pt, a, f"rec{i}")
        JA.save_array(pj, a, f"rec{i}")
        assert pt.read_bytes() == pj.read_bytes()
        for loader in (TA.load_array, JA.load_array):
            name, b = loader(pt)
            assert name == f"rec{i}" and b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
        assert TA.load_array(pj)[1].flags["F_CONTIGUOUS"] == JA.load_array(pj)[1].flags["F_CONTIGUOUS"]


@pytest.mark.parametrize("family", ["dcnet", "tonet", "jdc"])
def test_build_hmm_artifacts_byte_for_byte(tmp_path, rng, family):
    spec, jspec = family_spec(family), jax_family_spec(family)
    tracks = [_bin_track(rng, spec.n_bins)]
    build_hmm_artifacts(tracks, spec, tmp_path / "t")
    jax_build(tracks, jspec, tmp_path / "j")
    for f in ARTIFACTS:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    art = load_hmm_artifacts(tmp_path / "t")
    assert art["transition_matrix"].shape == (spec.n_bins + 1,) * 2


def test_family_specs_equal():
    for name in FAMILIES:
        t, j = family_spec(name), jax_family_spec(name)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (name, f.name)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f.name}")
            else:
                assert a == b, (name, f.name)
    from viterbi_spl_tpu.cli.hmm_artifacts import quantize_tracks_for_family as jax_q

    notes = [np.array([60.0, 0.0, 61.3, 99.0])]
    np.testing.assert_array_equal(
        quantize_tracks_for_family(notes, family_spec("tonet"))[0],
        jax_q(notes, jax_family_spec("tonet"))[0],
    )


def _jax_setup(kind, method, rng):
    if kind == "tonet":  # shaped matrix: the banded dispatch
        spec = jax_family_spec("tonet")
        stats = JP.count_statistics([_bin_track(rng, spec.n_bins)], spec.n_bins)
        A = JP.shape_transition_matrix(
            stats.transition_counts, stats.switch, spec.n_bins, spec.d_max, spec.floor
        )
        pi = JP.shape_init_probs(stats.p_steady)
        return JE.DecoderSetup(
            transition_matrix=A, init_probs=pi, n_bins=spec.n_bins,
            note_min=spec.note_min, bins_per_semitone=spec.bins_per_semitone,
            spw=spec.spw, voicing_threshold=spec.voicing_threshold,
            hop_seconds=spec.hop_seconds, method=method,
        )
    A, pi, _ = random_hmm(rng, 61, 4)  # dense: no banded structure
    return JE.DecoderSetup(
        transition_matrix=A, init_probs=pi.astype(np.float32), n_bins=60,
        note_min=40.0, bins_per_semitone=5.0, spw=3, voicing_threshold=0.4,
        hop_seconds=0.01, method=method,
    )


@pytest.mark.parametrize("kind", ["tonet", "dense"])
@pytest.mark.parametrize("method", METHODS)
def test_decoder_setup_from_numpy_matches_jax(rng, kind, method):
    js = _jax_setup(kind, method, rng)
    fields = dataclasses.asdict(js)
    del fields["fused_obs"], fields["mesh"]
    ts = TE.DecoderSetup.from_numpy(fields, device="cpu")
    assert ts.device == torch.device("cpu")
    logits = [_logits(rng, js.n_bins, T) for T in (70, 45)]
    for (jv, jb), (tv, tb) in zip(js.decode_batch(logits), ts.decode_batch(logits)):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(
        ts.observation_probs(logits[0]).numpy(),
        np.asarray(js.observation_probs(logits[0])), rtol=1e-5, atol=1e-30,
    )


def test_evaluate_posteriorgrams_counts_equal(rng):
    js = _jax_setup("dense", "shaun", rng)
    fields = dataclasses.asdict(js)
    del fields["fused_obs"], fields["mesh"]
    ts = TE.DecoderSetup.from_numpy(fields, device="cpu")
    tracks = []
    for T in (90, 60):
        logits = _logits(rng, 60, T)
        peak = logits.argmax(1)
        voiced = rng.random(T) > 0.2
        notes = np.where(voiced, 40.0 + peak / 5.0, 0.0).astype(np.float32)
        freqs = np.where(notes > 0, midi_to_hz(notes), 0.0)
        tracks.append(dict(logits=logits, notes=notes,
                           original=dict(times=np.arange(T) * 0.01, freqs=freqs)))
    got = TE.evaluate_posteriorgrams(ts, tracks)
    want = JE.evaluate_posteriorgrams(js, tracks)
    for path in ("raw", "viterbi"):
        for k, v in want[path].items():
            np.testing.assert_array_equal(got[path][k], v, err_msg=f"{path}.{k}")
        np.testing.assert_allclose(
            got[f"mir_eval_oas_{path}"], want[f"mir_eval_oas_{path}"], rtol=0, atol=1e-12
        )


def _cli_inputs(tmp_path, rng):
    spec = family_spec("tonet")
    build_hmm_artifacts([_bin_track(rng, spec.n_bins)], spec, tmp_path / "hmm")
    paths = []
    for i, T in enumerate((80, 110, 95)):
        p = tmp_path / f"track{i}.npy"
        np.save(p, _logits(rng, spec.n_bins, T))
        paths.append(p)
    return paths


@pytest.mark.parametrize("method", METHODS)
def test_decode_cli_matches_jax_cli(tmp_path, rng, method):
    """Same voiced/bins; frequencies within 1e-4 Hz plus 1e-6 relative.
    The est notes are float32 and differ by an ulp or two between the
    packages (XLA's and PyTorch's f32 sigmoid, and the order of the
    interpolation sums); one ulp of a note is 5.6e-5 Hz at 256 Hz and
    9e-4 Hz at 2 kHz, hence the relative term."""
    paths = _cli_inputs(tmp_path, rng)
    for fmt in ("txt", "npz"):
        common = [str(p) for p in paths] + [
            "--family", "tonet", "--artifacts", str(tmp_path / "hmm"),
            "--method", method, "--format", fmt, "--batch", "2",
        ]
        got = TD.main(common + ["--out", str(tmp_path / f"t_{fmt}"), "--device", "cpu"])
        want = JD.main(common + ["--out", str(tmp_path / f"j_{fmt}")])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["voiced"], w["voiced"])
            np.testing.assert_array_equal(g["bins"], w["bins"])
        for p in paths:
            if fmt == "txt":
                t = np.loadtxt(tmp_path / f"t_{fmt}" / f"{p.stem}.txt")
                j = np.loadtxt(tmp_path / f"j_{fmt}" / f"{p.stem}.txt")
                assert t.shape == j.shape == (np.load(p).shape[0], 2)
                np.testing.assert_allclose(t, j, rtol=HZ_RTOL, atol=HZ_ATOL)
            else:
                t = np.load(tmp_path / f"t_{fmt}" / f"{p.stem}.npz")
                j = np.load(tmp_path / f"j_{fmt}" / f"{p.stem}.npz")
                assert set(t.files) == set(j.files)
                np.testing.assert_array_equal(t["voiced"], j["voiced"])
                np.testing.assert_array_equal(t["bins"], j["bins"])
                np.testing.assert_allclose(t["freqs"], j["freqs"], rtol=HZ_RTOL, atol=HZ_ATOL)
                np.testing.assert_allclose(t["times"], j["times"], rtol=0, atol=0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """The port and chip_smoke.py's imports load no jax and no
    viterbi_spl_tpu module (a fresh interpreter: this one has jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import viterbi_spl_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib')\n"
        "       or m.startswith(('jax.', 'jaxlib.'))\n"
        "       or m == 'viterbi_spl_tpu' or m.startswith('viterbi_spl_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'viterbi_spl_tpu_torch.cli.decode' in sys.modules\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_default_device_raises_without_cuda(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, pi, _ = random_hmm(rng, 11, 4)
    kw = dict(transition_matrix=A, init_probs=pi, n_bins=10, note_min=40.0,
              bins_per_semitone=5.0, spw=2, voicing_threshold=0.4, hop_seconds=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.DecoderSetup(**kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.DecoderSetup(**kw, device="cuda")
    assert TE.DecoderSetup(**kw, device="cpu").device.type == "cpu"
