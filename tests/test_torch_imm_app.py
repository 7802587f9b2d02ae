"""The port's imm app (viterbi_spl_tpu_torch/apps/imm.py), its threshold
harness (harness/threshold.py) and its data copies (data/splits.py,
data/vocals.py) against the JAX package's, on the CPU, at the debug NMF
config (w=512, h=64, niters 15, R=6, P=8, K=4, bins_per_note=4).

Given the same fit, the decodes are exact: the 'original' method's (the
analytic matrix's log(A.T) through K3/K4's plain versions against the JAX
package's lax.scan decode) and the separation's melody states. Where the
port runs its own NMF, it starts from the JAX package's draws
(test_torch_imm.patch_fits_to_jax_draws); the resynthesised audio is held
within 1e-4 of its peak, as tests/test_torch_imm.py holds the
separations. The threshold sweep's counts are integers: its VA/OA grid
and the selected thresholds are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_imm import jax_fit, jax_mono_init, patch_fits_to_jax_draws
from viterbi_spl_tpu.apps import imm as JA
from viterbi_spl_tpu.data import splits as JS
from viterbi_spl_tpu.data import vocals as JV
from viterbi_spl_tpu.harness import evaluate as JE
from viterbi_spl_tpu.harness import threshold as JT
from viterbi_spl_tpu.hmm.viterbi import viterbi_backtrace_jax, viterbi_forward_jax
from viterbi_spl_tpu.models import imm as JM
from viterbi_spl_tpu_torch.apps import imm as TA
from viterbi_spl_tpu_torch.data import splits as TS
from viterbi_spl_tpu_torch.data import vocals as TV
from viterbi_spl_tpu_torch.harness import evaluate as TE
from viterbi_spl_tpu_torch.harness import threshold as TT
from viterbi_spl_tpu_torch.models import imm as TM


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)  # ROADMAP §3: one thread for float comparisons
    j = JM.IMM(JA.debug_imm_config())
    return j, TM.IMM(TM.IMMConfig(**dataclasses.asdict(j.config)), device="cpu")


def tone(n, f0, rng, sr=44100):
    t = np.arange(n) / sr
    y = sum((0.6 / k) * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 5))
    return (y + 0.02 * rng.normal(size=n)).astype(np.float32)


def _fields(setup):
    return {f.name: getattr(setup, f.name) for f in dataclasses.fields(JE.DecoderSetup)
            if f.name not in ("transition_matrix", "init_probs", "mesh")}


@pytest.mark.parametrize("stats", ["shaped", "analytic", "degenerate"])
def test_build_setup_matches_jax(pair, stats):
    """build_setup's A and pi, and every field, on both branches: the
    data-counted shaped matrix from labels with an unvoiced stretch, the
    analytic matrix without labels and as the fallback for all-voiced
    labels (the weakness ADVICE.md notes, kept as it is)."""
    j, t = pair
    notes = np.full(300, 57.0, np.float32)
    if stats == "shaped":
        notes[100:200] = 0.0
    stats_notes = None if stats == "analytic" else [notes, notes[::2]]
    want = JA.build_setup(j, stats_notes=stats_notes)
    got = TA.build_setup(t, stats_notes=stats_notes)
    np.testing.assert_array_equal(got.transition_matrix, want.transition_matrix)
    np.testing.assert_array_equal(got.init_probs, want.init_probs)
    assert _fields(got) == _fields(want)
    analytic = stats != "shaped"
    assert np.array_equal(got.transition_matrix, t.transition_matrix) == analytic
    assert got.device == torch.device("cpu")


def test_original_method_matches_jax(rng, pair):
    """Two tracks' JAX fits: original_states (one batch through the dense
    decode's plain versions) equals the JAX package's per-track lax.scan
    decode exactly, and evaluate_imm_original its OAs."""
    j, t = pair
    items = []
    for n, f0 in ((44100 // 3, 220.0), (44100 // 5, 330.0)):
        y = np.concatenate([tone(n, f0, rng), 0.001 * rng.normal(size=n // 3).astype(np.float32)])
        SX = np.asarray(jnp.abs(j.stft.stft(y))) ** 2
        fit, _ = jax_fit(j, SX, jax_mono_init(j.config, SX.shape[0], seed=len(items)))
        T = SX.shape[0]
        notes = np.where(np.arange(T) < n // j.config.h, 57.0, 0.0).astype(np.float32)
        items.append(dict(SX=SX, fit=fit, notes=notes, original=dict(
            times=np.arange(T) * j.config.h / j.config.fs,
            freqs=np.where(notes > 0, 440.0 * 2 ** ((notes - 69) / 12), 0.0))))
    U = j.config.U
    log_B = np.log(j.transition_matrix.T).astype(np.float32)
    log_pi = np.full(U + 1, -np.log(U + 1), np.float32)
    got = TA.original_states(t, [it["fit"] for it in items])
    for item, states in zip(items, got):
        t1, T2 = viterbi_forward_jax(jnp.asarray(log_B), jnp.asarray(log_pi),
                                     jnp.asarray(j.process_HF0(item["fit"]["HF0"]).T))
        want = np.asarray(viterbi_backtrace_jax(T2, jnp.argmax(t1).astype(jnp.int32)))
        np.testing.assert_array_equal(states, want)
    tfits = [dict(it, fit={k: torch.from_numpy(v) if k != "err" else v
                           for k, v in it["fit"].items()}) for it in items]
    assert TA.evaluate_imm_original(t, tfits) == JA.evaluate_imm_original(j, items)


def test_separate_stereo_samples_matches_jax(rng, pair, monkeypatch):
    """separate_stereo_samples given the JAX package's mono fit (and the
    stereo pass from its draws): the JAX package's melody states exactly,
    the resynthesised channels within 1e-4 of their peak, and melody +
    accompaniment reconstructs the mix."""
    j, t = pair
    n = int(0.4 * 44100)
    voice = tone(n, 220.0, rng)
    acc = (0.15 * rng.normal(size=n)).astype(np.float32)
    left, right = 0.8 * voice + 0.3 * acc, 0.4 * voice + 0.8 * acc
    setup_j = JA.build_setup(j)
    want = JA.separate_stereo_samples(j, left, right, setup_j, seed=0)

    XL, XR = np.asarray(j.stft.stft(left)), np.asarray(j.stft.stft(right))
    SX = np.abs(0.5 * (XL + XR)) ** 2
    jfit, _ = jax_fit(j, SX, jax_mono_init(j.config, SX.shape[0], seed=0))
    patch_fits_to_jax_draws(monkeypatch)
    monkeypatch.setattr(TM.IMM, "fit", lambda self, SX, seed=0: {
        k: torch.from_numpy(v) if k != "err" else v for k, v in jfit.items()} | {"sweeps": 0})
    got = TA.separate_stereo_samples(t, left, right, TA.build_setup(t), seed=0)
    np.testing.assert_array_equal(got["states"], want["states"])
    np.testing.assert_array_equal(got["voiced"], want["voiced"])
    assert 0 < got["voiced"].mean()
    for key in ("melody", "accompaniment"):
        assert got[key].shape == want[key].shape == (n, 2) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max())
    mix = np.stack([left, right], 1)
    err = np.mean((got["melody"] + got["accompaniment"] - mix) ** 2) / np.mean(mix**2)
    assert err < 0.5  # tests/test_transcribe.py::test_imm_stereo_separation's bound


def _tracks(rng, n_bins, n_tracks=3, voicing=False):
    out = []
    for i in range(n_tracks):
        T = 40 + 17 * i
        lg = rng.normal(-1.0, 2.0, (T, n_bins)).astype(np.float32)
        notes = np.where(rng.random(T) < 0.3, 0.0, 60.0 + rng.normal(0, 2, T)).astype(np.float32)
        rec = dict(logits=lg, notes=notes)
        if voicing:
            rec["voicing_logits"] = rng.normal(0, 2, T).astype(np.float32)
        out.append(rec)
    return out


@pytest.mark.parametrize("kind", ["imm", "probability", "voicing head"])
def test_sweep_voicing_thresholds_matches_jax(rng, pair, kind):
    """The raw-path sweep on the same logits: the threshold grid, its VA
    and OA, and the selected thresholds equal the JAX package's (imm's
    log-energy grid; a probability grid with interpolated notes; jdc's
    voicing head with direct notes)."""
    j, t = pair
    if kind == "imm":
        want_setup = JA.build_setup(j)
        tracks = _tracks(rng, j.config.U)
    else:
        n_bins = 40
        A = np.full((n_bins + 1, n_bins + 1), 1.0 / (n_bins + 1))
        want_setup = JE.DecoderSetup(
            transition_matrix=A, init_probs=np.full(n_bins + 1, 1.0 / (n_bins + 1)),
            n_bins=n_bins, note_min=50.0, bins_per_semitone=2.0, spw=2, voicing_threshold=0.5,
            hop_seconds=0.01, interp_est_notes=kind == "probability")
        tracks = _tracks(rng, n_bins, voicing=kind == "voicing head")
    got_setup = TE.DecoderSetup.from_numpy(dataclasses.asdict(want_setup), device="cpu")
    got, want = TT.sweep_voicing_thresholds(got_setup, tracks), \
        JT.sweep_voicing_thresholds(want_setup, tracks)
    for key in ("thresholds", "va", "oa"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["best_threshold"] == want["best_threshold"]
    assert got["best_oa_threshold"] == want["best_oa_threshold"]


def test_hard_vs_auto_and_obs_sweep_match_jax(rng, pair):
    """The two harness sweeps built on the sweep and the decode, on imm's
    debug setup: equal to the JAX package's."""
    j, _ = pair
    setup_j = JA.build_setup(j, stats_notes=[np.where(np.arange(200) % 50 < 10, 0.0, 57.0)])
    setup_t = TE.DecoderSetup.from_numpy(dataclasses.asdict(setup_j), device="cpu")
    val, test = _tracks(rng, j.config.U, 2), _tracks(rng, j.config.U, 2)
    got = TT.hard_vs_auto(setup_t, val, test, hard_threshold=2.0)
    want = JT.hard_vs_auto(setup_j, val, test, hard_threshold=2.0)
    assert got["auto_threshold"] == want["auto_threshold"]
    for key in ("auto", "hard"):
        assert got[key]["viterbi_mean_oa"] == want[key]["viterbi_mean_oa"]
        assert got[key]["raw_mean_oa"] == want[key]["raw_mean_oa"]
    got = TT.sweep_obs_hyperparams(setup_t, val, ps=(0.7, 0.8), scales=(1.0, 2.0))
    want = JT.sweep_obs_hyperparams(setup_j, val, ps=(0.7, 0.8), scales=(1.0, 2.0))
    np.testing.assert_array_equal(got["oa"], want["oa"])
    assert (got["best_p"], got["best_scale"]) == (want["best_p"], want["best_scale"])


def test_imm_app_main_matches_jax(monkeypatch):
    """`eval --synthetic --debug --original --calibrate-threshold` through
    both apps' main, the port's NMF from the JAX package's draws: the same
    OAs of the three methods and the same calibrated threshold. With
    --external-eval and no corpus root set, the JAX app's outputs and no
    corpus keys."""
    patch_fits_to_jax_draws(monkeypatch)
    argv = ["eval", "--synthetic", "--debug", "--original", "--calibrate-threshold"]
    got = TA.main(argv + ["--device", "cpu"])
    want = JA.main(argv)
    for key in ("raw_mean_oa", "viterbi_mean_oa"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got["original"]["oas"] == pytest.approx(want["original"]["oas"], abs=1e-6)
    assert got["calibration"]["best_threshold"] == want["calibration"]["best_threshold"]
    np.testing.assert_array_equal(got["calibration"]["va"], want["calibration"]["va"])
    for corpus in ("adc04", "mirex05", "mir1k", "rwc"):
        monkeypatch.delenv(corpus, raising=False)
    argv = ["eval", "--synthetic", "--debug", "--external-eval"]
    got, want = TA.main(argv + ["--device", "cpu"]), JA.main(argv)
    assert sorted(got) == sorted(want) and not {"adc04", "mirex05", "mir1k", "rwc"} & set(got)
    for key in ("raw_mean_oa", "viterbi_mean_oa"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key


def test_splits_and_vocals_match_jax(tmp_path):
    assert TS.medleydb_splits() == JS.medleydb_splits()
    for name in ("adc04_track_ids", "mirex05_track_ids", "rwc_track_ids"):
        assert getattr(TS, name)() == getattr(JS, name)(), name
    (tmp_path / "Wavfile").mkdir()
    for name in ("b_2", "a_1"):
        (tmp_path / "Wavfile" / f"{name}.wav").write_bytes(b"")
    assert TS.mir1k_track_ids(str(tmp_path)) == JS.mir1k_track_ids(str(tmp_path)) == ["a_1", "b_2"]

    n = 200
    times = np.arange(n) * (256 / 44100)
    freqs = np.where(np.arange(n) % 5 == 0, 0.0, 220.0)
    np.savetxt(tmp_path / "T_MELODY2.csv", np.stack([times, freqs], 1), delimiter=",")
    with open(tmp_path / "T_SOURCEID.lab", "w") as fh:
        fh.write("start_time,end_time,instrument_label\n0.1,0.6,male singer\n0.7,0.9,piano\n")
    kw = dict(section_dir=str(tmp_path), melody2_dir=str(tmp_path))
    got, want = TV.is_vocals_from_sections("T", **kw), JV.is_vocals_from_sections("T", **kw)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n
    m2 = np.stack([times[:6], [0, 220, 330, 220, 0, 440]], 1)
    m3 = np.stack([times[:6], [0, 220, 330, 220, 0, 440], [0, 0, 330, 110, 0, 440]], 1)
    args = (m2, m3, {1: 1, 2: 2}, {1: "male singer", 2: "violin"}, False)
    np.testing.assert_array_equal(TV.is_vocals_from_m2m3(*args), JV.is_vocals_from_m2m3(*args))
