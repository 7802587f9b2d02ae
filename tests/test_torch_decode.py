"""The port's decode service end to end against the JAX package: .dat
artifacts, DecoderSetup, evaluate_posteriorgrams and the decode CLI, on
the CPU (`device="cpu"`); plus the import boundary, the device rule and
the decode APIs' cache of prepared HMMs (hmm/prepared.py): each HMM built
once, found again by content, rebuilt when edited, the oldest evicted,
safe under threads, with paths equal to the oracle's throughout."""

import dataclasses
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.cli import decode as JD
from viterbi_spl_tpu.cli.hmm_artifacts import build_hmm_artifacts as jax_build
from viterbi_spl_tpu.families import family_spec as jax_family_spec
from viterbi_spl_tpu.harness import evaluate as JE
from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.io import array_file as JA
from viterbi_spl_tpu_torch import tracing
from viterbi_spl_tpu_torch.cli import decode as TD
from viterbi_spl_tpu_torch.cli.hmm_artifacts import (
    build_hmm_artifacts,
    load_hmm_artifacts,
    quantize_tracks_for_family,
)
from viterbi_spl_tpu_torch.families import FAMILIES, family_spec
from viterbi_spl_tpu_torch.harness import evaluate as TE
from viterbi_spl_tpu_torch.hmm import obs_fused as OF
from viterbi_spl_tpu_torch.hmm import params as TP
from viterbi_spl_tpu_torch.hmm import prepared as HP
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TVD
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle, viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params
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
    ts = TE.DecoderSetup.from_numpy(dataclasses.asdict(js), device="cpu")
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
    ts = TE.DecoderSetup.from_numpy(dataclasses.asdict(js), device="cpu")
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


def _small_shaped(rng, n_bins=16, d_max=3):
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-2, 3, 600)), 0, n_bins - 1)]
    stats = TP.count_statistics(walk, n_bins)
    A = TP.shape_transition_matrix(stats.transition_counts,
                                   np.array([[0.95, 0.05], [0.1, 0.9]]), n_bins, d_max, 2)
    return A, TP.shape_init_probs(stats.p_steady, p_th=1e-4)


def _traced_decode(A, pi, tracks):
    """viterbi_decode_batch on the CPU with spans recording: (paths, spans)."""
    tracing.clear()
    with tracing.enabled():
        paths = TVD.viterbi_decode_batch(transition_matrix=A, prob_init=pi, probs_st_list=tracks,
                                         device="cpu")
    spans = tracing.spans()
    tracing.clear()
    return paths, spans


def _counts(spans):
    return tuple(sum(s.counts.get(k, 0) for s in spans) for k in ("tables_built", "tables_reused"))


def _assert_oracle(paths, A, pi, tracks):
    for p, obs in zip(paths, tracks):
        np.testing.assert_array_equal(p, viterbi_oracle(transition_matrix=A, prob_init=pi,
                                                        probs_st=obs))


@pytest.mark.parametrize("case", ["repeat", "equal_copy", "edited_in_place", "other_pi", "dense",
                                  "evicted"])
def test_decode_apis_prepare_each_hmm_once(rng, case):
    """A first decode builds the prepared HMM (tables_built 1); a second
    finds it (tables_reused 1) for the same matrix or an equal copy, and
    builds anew for a matrix edited in place, another pi, or an HMM the
    cache evicted for newer ones. A dense matrix is cached without a band
    and takes K3/K4's route. Paths equal the oracle's on every call."""
    HP.clear()
    A, pi = random_hmm(rng, 17, 4)[:2] if case == "dense" else _small_shaped(rng)
    S = A.shape[0]
    tracks = [random_hmm(rng, S, T, sparse_obs=True)[2] for T in (23, 1, 40)]
    paths, spans = _traced_decode(A, pi, tracks)
    assert _counts(spans) == (1, 0)
    _assert_oracle(paths, A, pi, tracks)
    hmm = HP.cached()[-1]
    if case == "dense":
        assert hmm.banded is None and hmm.card("cpu").log_B is not None
        assert {s.attrs.get("route") for s in spans if s.name == "decode"} == {None, "dense"}
    else:
        assert hmm.banded is not None and hmm.card("cpu").profiles is not None
    A2, pi2, want = A, pi, (0, 1)
    if case == "equal_copy":
        A2, pi2 = A.copy(), pi.copy()
    elif case == "edited_in_place":
        old = [viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=o) for o in tracks]
        A[...] = _small_shaped(rng, d_max=1)[0]
        new = [viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=o) for o in tracks]
        assert any((a != b).any() for a, b in zip(old, new))
        want = (1, 0)
    elif case == "other_pi":
        pi2, want = np.roll(pi, 3), (1, 0)
    elif case == "evicted":
        for k in range(HP.CACHE_SIZE):
            _traced_decode(A, np.roll(pi, k + 1), tracks[:1])
        assert hmm not in HP.cached() and len(HP.cached()) == HP.CACHE_SIZE
        want = (1, 0)
    paths, spans = _traced_decode(A2, pi2, tracks)
    assert _counts(spans) == want
    _assert_oracle(paths, A2, pi2, tracks)
    assert len(HP.cached()) <= HP.CACHE_SIZE


@pytest.mark.parametrize("fused_obs", [False, True])
def test_decoder_setup_hands_its_prepared_hmm_to_the_apis(rng, fused_obs):
    """A DecoderSetup builds its prepared HMM once, when it is made: its
    first decode builds nothing, even with the cache emptied since, and
    decodes as the oracle does."""
    A, pi = _small_shaped(rng)
    n_bins = A.shape[0] - 1
    setup = TE.DecoderSetup(transition_matrix=A, init_probs=pi, n_bins=n_bins, note_min=40.0,
                            bins_per_semitone=1.0, spw=2, voicing_threshold=0.4,
                            hop_seconds=0.01, fused_obs=fused_obs, device="cpu")
    HP.clear()
    logits = [rng.normal(size=(T, n_bins)).astype(np.float32) for T in (30, 9)]
    tracing.clear()
    with tracing.enabled():
        got = setup.decode_batch(logits)
    assert _counts(tracing.spans()) == (0, 1) and HP.cached() == []
    tracing.clear()
    log_B, log_pi = prepare_log_params(A, pi)
    for lg, (voiced, bins) in zip(logits, got):
        if fused_obs:
            log_obs = OF.log_obs_plain(torch.from_numpy(lg)[None], setup.obs_config())[0]
            want = viterbi_oracle_log(log_B, log_pi, log_obs.numpy())
        else:
            obs = setup.observation_probs(lg).numpy()
            want = viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs.T)
        np.testing.assert_array_equal(voiced, want < n_bins)
        np.testing.assert_array_equal(bins, np.minimum(want, n_bins - 1))


def test_prepared_hmm_cache_under_threads():
    """More threads than cores look up more HMMs than the cache holds, with
    a short switch interval: every lookup returns its own HMM, the cache
    never holds two equal entries nor more than CACHE_SIZE, and a device's
    card tables are made once an HMM."""
    HP.clear()
    rng = np.random.default_rng(7)
    hmms = [random_hmm(rng, 6, 1)[:2] for _ in range(HP.CACHE_SIZE + 2)]
    faults = []

    def work(k):
        for i in range(60):
            A, pi = hmms[(k + i) % len(hmms)]
            got = HP.prepared_hmm(A, pi)
            if not got.matches(np.float32(A), np.float32(pi)):
                faults.append("wrong hmm")
            if got.card("cpu") is not got.card("cpu"):
                faults.append("card tables made twice")
            cached = HP.cached()
            if len(cached) > HP.CACHE_SIZE or len({id(h) for h in cached}) != len(cached) or any(
                    a.matches(b.A, b.pi) for i, a in enumerate(cached) for b in cached[i + 1:]):
                faults.append("cache broken")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert faults == []
    HP.clear()
