"""The port's transcription slice (viterbi_spl_tpu_torch/cli/transcribe.py and
what it stands on: apps/, harness/train.py, data/, cli/hmm_artifacts.py's
main, scripts/orbax_to_torch.py) against the JAX package's, on the CPU.

The slice test writes a short synthetic wav, makes a JAX package checkpoint
(the JAX model's param tree filled with seeded values, saved by its
Trainer, as tests/test_transcribe.py:38-58 does), converts it with
scripts/orbax_to_torch.py, and runs both packages' transcribe CLIs with
--family tonet, --family jdc and --family dcnet (44.1 kHz, the NSGT
front-end). The imm tests run both CLIs' checkpoint-free chains (--debug,
and --separate --debug) with the port's NMF started from the JAX package's
draws (tests/test_torch_imm.py::patch_fits_to_jax_draws). TONet is narrowed to attn_dim 32 on
both sides (the JAX app's config is patched; the port reads the width
from the converted params), and the JAX model init is patched to the
seeded param tree (flax's own init compiles for about a minute here; the
checkpoint restore overwrites it anyway).

- The port's decoder on the JAX package's logits gives the JAX CLI's
  voicing, bins and frame times exactly, and its melody line's Hz within
  tests/test_torch_decode.py's rtol 1e-6 (atol 1e-4): the interpolated
  note is float32 arithmetic in two frameworks (decoder exactness, apart
  from the model).
- Logits, each CLI on its own package's front-end. The port's front-ends
  compute in float64 and the JAX package's in float32, whose error is the
  difference: on this kind of plain tone up to 3.5e-3 of a CFP part's
  maximum and 0.024 of the jdc spectrogram's range
  (scripts/precision_probe.py; tests/test_torch_frontend.py holds both
  port front-ends to float64 references within 1e-6). The test prints
  its measured differences (pytest -s). jdc (eval-mode BatchNorm): within 2e-3 of the
  largest |logit| and a relative L2 error of 1e-3; measured 6.0e-4 and
  3.2e-4 here. TONet (normalized by the track's own chunk statistics, here 2
  chunks, which a random-weight network makes sensitive to its input):
  within 5e-2 and 3e-2; measured 1.8 % and 0.75 %. On the same input each
  port model is within 1e-4 of the JAX model in eval mode, and TONet's
  batch-statistics forward within 2e-3 of the JAX model's in float64
  (tests/test_torch_models.py). The JAX
  batch-statistics forward runs TONet's Dropout layers with a fixed key;
  they are intercepted to the identity on the JAX side here: the port
  runs none. dcnet (eval-mode BatchNorm) on the NSGT feature, which the
  two packages compute within 1e-4 of each other
  (tests/test_torch_nsgt.py): within 1e-3 of the largest |logit| and a
  relative L2 error of 1e-4 (the printed measurements are below both).
- imm: the decoder exact on the JAX package's logits (the separation's
  mono logits too), and melody + accompaniment reconstruct the mix within
  tests/test_transcribe.py::test_imm_stereo_separation's bound. The
  log-energy logits: on the separation's mix (a voice over a noise
  accompaniment) within tests/test_torch_imm.py's LOGIT_ATOL (1e-4); on
  tests/test_transcribe.py's noiseless PCM tone within 1e-2 (measured
  2.3e-3). The two packages' float32 STFTs differ by 3.6e-7 of the largest
  power, which the tone's near-silent bins (powers down to 1e-12 of it)
  turn into large relative differences of SX that the fit carries into the
  logits: from the JAX package's own SX the port's fit lands within 3e-6
  (tests/test_torch_imm.py), and with 0.02 noise added to the tone the two
  CLIs' logits are 2.6e-5 apart.
"""

import argparse
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from scipy.io import wavfile

import viterbi_spl_tpu.apps.common as j_common
import viterbi_spl_tpu.apps.tonet as j_tonet_app
from viterbi_spl_tpu.cli import hmm_artifacts as JH
from viterbi_spl_tpu.cli import transcribe as JTR
from viterbi_spl_tpu.data import labels as JL
from viterbi_spl_tpu.data import snippets as JSN
from viterbi_spl_tpu.data.registry import Track as JTrack
from viterbi_spl_tpu.families import family_spec as j_family_spec
from viterbi_spl_tpu.harness.train import Trainer as JTrainer
from viterbi_spl_tpu.harness.train import TrainState as JTrainState
from viterbi_spl_tpu.io.wav import load_wav as j_load_wav
from viterbi_spl_tpu.models.tonet import TONet as JTONet
from test_torch_imm import LOGIT_ATOL, patch_fits_to_jax_draws
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.models import imm as JM
from viterbi_spl_tpu_torch.apps import imm as TA
from viterbi_spl_tpu_torch.apps import tonet as t_tonet_app
from viterbi_spl_tpu_torch.apps.common import init_model
from viterbi_spl_tpu_torch.cli import decode as TD
from viterbi_spl_tpu_torch.cli import hmm_artifacts as TH
from viterbi_spl_tpu_torch.cli import transcribe as TTR
from viterbi_spl_tpu_torch.data import labels as TL
from viterbi_spl_tpu_torch.data import snippets as TSN
from viterbi_spl_tpu_torch.data.registry import Track
from viterbi_spl_tpu_torch.harness.train import TrainState, restore_checkpoint, save_checkpoint
from viterbi_spl_tpu_torch.models import imm as TM

ROOT = Path(__file__).resolve().parent.parent
# (max |diff| over the largest |logit|, relative L2 error)
LOGIT_TOL = {"jdc": (2e-3, 1e-3), "tonet": (5e-2, 3e-2), "dcnet": (1e-3, 1e-4)}
IMM_TONE_LOGIT_ATOL = 1e-2


def _load_converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", ROOT / "scripts" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_variables(model, sample, seed=0):
    """The flax model's variable trees (eval_shape of its init) with seeded
    values (tests/test_torch_models.py::flax_variables)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(sample), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape)
        elif name in ("scale", "var"):
            v = 1 + np.abs(rng.normal(0, 0.1, leaf.shape))
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, v) for k, v in shapes.items()}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _write_wav(path, sr, seconds):
    """Two different notes (220 Hz, then 330 Hz with noise), a few harmonics
    each, so that the chunks differ."""
    t = np.arange(int(seconds * sr)) / sr
    f = np.where(t < seconds / 2, 220.0, 330.0)
    x = sum(a * np.sin(2 * np.pi * k * f * t) for k, a in ((1, 0.5), (2, 0.25), (3, 0.125)))
    x = x + np.where(t < seconds / 2, 0.0, 0.05) * np.random.default_rng(7).normal(size=len(t))
    wavfile.write(path, sr, (x * 32767 * 0.8).astype(np.int16))


def _artifacts(path, family, rng):
    spec = j_family_spec(family)
    track = np.clip(spec.n_bins // 2 + np.cumsum(rng.integers(-2, 3, 3000)), 0, spec.n_bins - 1)
    track = np.where(np.repeat(rng.random(151) > 0.3, 20)[:3000], track, spec.n_bins)
    JH.build_hmm_artifacts([track], spec, path)
    return path


@pytest.fixture
def narrow_jax_apps(monkeypatch):
    """The JAX tonet app at attn_dim 32, and the JAX model init as the
    seeded param tree."""
    wide = j_tonet_app.config

    def config():
        return dataclasses.replace(wide(), make_model=lambda **kw: JTONet(attn_dim=32, **kw))

    def fast_init(cfg, sample_batch):
        model = cfg.make_model(dtype=cfg.compute_dtype)
        v = _seeded_variables(model, sample_batch)
        return model, v["params"], v.get("batch_stats", {})

    monkeypatch.setattr(j_tonet_app, "config", config)
    monkeypatch.setattr(j_common, "init_model", fast_init)


@pytest.mark.parametrize("family,seconds", [("tonet", 2.0), ("jdc", 1.0), ("dcnet", 1.0)])
def test_transcribe_matches_jax(tmp_path, rng, narrow_jax_apps, monkeypatch, family, seconds):
    """Both transcribe CLIs on one wav through one checkpoint (converted by
    scripts/orbax_to_torch.py): logits within the stated tolerance; the
    port's decoder on the JAX logits gives the JAX CLI's melody exactly;
    the port CLI writes one line a frame on the family's hop grid."""
    wav = tmp_path / "song.wav"
    sr = JTR.FAMILY_SR[family]
    _write_wav(wav, sr, seconds)
    art = _artifacts(tmp_path / "hmm", family, rng)

    # the JAX checkpoint, as tests/test_transcribe.py:38-58 makes one
    cfg = importlib.import_module(f"viterbi_spl_tpu.apps.{family}").config()
    feats = JTR.features_from_samples(family, j_load_wav(wav, sr=sr)[0])
    sample = feats[: cfg.snippet_len][None]
    if cfg.input_adapter is not None:
        sample = np.asarray(cfg.input_adapter(jnp.asarray(sample)))
    _, params, batch_stats = j_common.init_model(cfg, sample)
    state = JTrainState(params=params, batch_stats=batch_stats,
                        opt_state=optax.adam(1e-4).init(params), voicing_threshold=0.4)
    JTrainer(None, None, ckpt_path=str(tmp_path / "jax_ckpt")).save(state)
    pt = tmp_path / f"{family}.pt"
    _load_converter().main(["--family", family, str(tmp_path / "jax_ckpt"), str(pt)])

    # both CLIs, each one's logits kept on the way
    kept = {}

    def keep(module, key):
        real = module.nn_logits_from_wavs

        def spy(*args, **kwargs):
            kept[key] = real(*args, **kwargs)
            return kept[key]

        monkeypatch.setattr(module, "nn_logits_from_wavs", spy)

    keep(JTR, "jax")
    keep(TTR, "port")
    common = [str(wav), "--family", family, "--artifacts", str(art), "--format", "npz"]
    with nn.intercept_methods(_no_dropout):
        j_res = JTR.main(common + ["--ckpt", str(tmp_path / "jax_ckpt"), "--out", str(tmp_path / "j")])
    stages = {}
    t_res = TTR.main(common + ["--ckpt", str(pt), "--out", str(tmp_path / "t"), "--device", "cpu"],
                     stages=stages)
    assert set(stages) == {"wav_load", "front_end", "model_load", "model", "decode"}
    j_logits = kept["jax"][0][0]
    t_logits, t_state = kept["port"]
    assert t_state.voicing_threshold == pytest.approx(0.4)
    assert t_logits[0].shape == j_logits.shape == (len(feats), j_family_spec(family).n_bins)
    max_tol, l2_tol = LOGIT_TOL[family]
    err = float(np.abs(t_logits[0] - j_logits).max())
    assert err <= max_tol * float(np.abs(j_logits).max()), err
    rel = float(np.linalg.norm(t_logits[0] - j_logits) / np.linalg.norm(j_logits))
    print(f"{family} logits: max |diff| {err / float(np.abs(j_logits).max())} of the largest, "
          f"relative L2 {rel}")
    assert rel <= l2_tol, rel

    # the port's decoder on the JAX logits: the JAX CLI's melody, exactly
    args = argparse.Namespace(family=family, artifacts=str(art), threshold=0.4,
                              method="shaun", device="cpu", out=str(tmp_path / "x"),
                              batch=16, format="npz")
    setup = TD.build_setup(args)
    got = TD.decode_named_logits(setup, ["song"], [j_logits], args, write=False)[0]
    for key in ("voiced", "bins", "times"):
        np.testing.assert_array_equal(got[key], j_res[0][key], err_msg=key)
    np.testing.assert_allclose(got["freqs"], j_res[0]["freqs"], rtol=1e-6, atol=1e-4)
    d = np.load(tmp_path / "t" / "song.npz")
    assert len(d["freqs"]) == len(t_res[0]["freqs"]) == len(feats)
    np.testing.assert_allclose(d["times"][1], j_family_spec(family).hop_seconds)


def test_transcribe_refuses_what_comes_in_slice_9(tmp_path):
    """The refusals that stay once dcnet, imm and --separate are ported:
    --separate is imm's alone, the NN families need --ckpt, and without
    --device every chain wants CUDA (no fallback to the CPU)."""
    wav = tmp_path / "a.wav"
    _write_wav(wav, 8000, 0.2)
    for family in ("tonet", "dcnet"):
        with pytest.raises(SystemExit, match="imm stereo separation"):
            TTR.main([str(wav), "--out", str(tmp_path / "o"), "--family", family, "--separate"])
    for family in ("jdc", "dcnet"):
        with pytest.raises(SystemExit, match="--ckpt is required"):
            TTR.main([str(wav), "--family", family, "--out", str(tmp_path / "o")])
    if not torch.cuda.is_available():  # the default device is CUDA: no fallback
        for family in ("tonet", "dcnet"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TTR.features_from_samples(family, np.zeros(800, np.float32))
        for extra in ([], ["--separate"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TTR.main([str(wav), "--family", "imm", "--debug", "--out", str(tmp_path / "o")]
                         + extra)


def _stereo_wav(path, seconds, sr=44100):
    """tests/test_transcribe.py::test_imm_stereo_separation's mix: a
    harmonic voice and noise, panned differently, PCM16."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    voice = sum((0.5 / k) * np.sin(2 * np.pi * 220.0 * k * t) for k in range(1, 5))
    accomp = 0.15 * np.random.default_rng(0).normal(size=n)
    mix = np.stack([0.8 * voice + 0.3 * accomp, 0.4 * voice + 0.8 * accomp], 1)
    wavfile.write(path, sr, np.clip(mix * 32767, -32768, 32767).astype(np.int16))
    return j_load_wav(path, mono=False)[0]


@pytest.mark.parametrize("separate", [False, True])
def test_transcribe_imm_matches_jax(tmp_path, monkeypatch, separate):
    """Both CLIs with --family imm --debug (with --separate: a stereo wav
    through the separation pass). The port's NMF starts from the JAX
    package's draws. Its log-energy logits (the separation's mono logits
    too) within LOGIT_ATOL of the JAX CLI's; the port's decoder on the JAX
    logits gives the JAX CLI's states exactly; the separation writes both
    stereo wavs and the melody line, and melody + accompaniment
    reconstructs the mix."""
    wav = tmp_path / "mix.wav"
    if separate:
        mix = _stereo_wav(wav, 0.6)
    else:
        _write_wav(wav, 44100, 0.35)
    patch_fits_to_jax_draws(monkeypatch)
    kept = {"jax": [], "port": []}
    for key, cls in (("jax", JM.IMM), ("port", TM.IMM)):
        real = cls.logits_from_fit

        def spy(self, fit, SX, _real=real, _key=key):
            kept[_key].append(_real(self, fit, SX))
            return kept[_key][-1]

        monkeypatch.setattr(cls, "logits_from_fit", spy)
    extra = ["--separate"] if separate else ["--format", "npz"]
    common = [str(wav), "--family", "imm", "--debug"] + extra
    j_res = JTR.main(common + ["--out", str(tmp_path / "j")])
    stages = {}
    t_res = TTR.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"], stages=stages)
    assert len(kept["jax"]) == len(kept["port"]) == 1
    j_logits, t_logits = kept["jax"][0], kept["port"][0]
    assert t_logits.shape == j_logits.shape and t_logits.shape[0] == TA.debug_imm_config().U
    err = float(np.abs(t_logits - j_logits).max())
    print(f"imm logits (separate={separate}): max |diff| {err}")
    assert err <= (LOGIT_ATOL if separate else IMM_TONE_LOGIT_ATOL), err

    # the port's decoder on the JAX logits: the JAX CLI's states, exactly
    imm = TM.IMM(TA.debug_imm_config(), device="cpu")
    setup = TA.build_setup(imm)
    voiced, bins = setup.decode(j_logits.T)
    states = np.where(voiced, bins, imm.config.U)
    if separate:
        np.testing.assert_array_equal(states, j_res[0]["states"])
        assert set(stages) == {"wav_load", "separate"}
        for part in ("melody", "accompaniment"):
            out, sr = j_load_wav(tmp_path / "t" / f"mix_{part}.wav", mono=False)
            assert sr == 44100 and out.shape == mix.shape
        r = t_res[0]
        err = np.mean((r["melody"] + r["accompaniment"] - mix) ** 2) / np.mean(mix**2)
        assert err < 0.5, err
        assert np.loadtxt(tmp_path / "t" / "mix_melody.txt").shape == (len(r["states"]), 2)
    else:
        np.testing.assert_array_equal(voiced, j_res[0]["voiced"])
        np.testing.assert_array_equal(bins, j_res[0]["bins"])
        assert set(stages) == {"wav_load", "stft", "nmf_fit", "energies", "sweeps", "decode"}
        assert len(stages["sweeps"]) == 1 and 1 <= stages["sweeps"][0] <= TA.debug_imm_config().niters
        d = np.load(tmp_path / "t" / "mix.npz")
        assert len(d["freqs"]) == j_logits.shape[1]
        np.testing.assert_allclose(d["times"][1], TA.debug_imm_config().h / 44100)


def test_checkpoint_round_trip(tmp_path):
    cfg = t_tonet_app.config()
    model, params, batch_stats = init_model(cfg, dict(attn_dim=32), seed=3)
    save_checkpoint(tmp_path / "c.pt", TrainState(params, batch_stats, voicing_threshold=0.3,
                                                  epoch=4, best_oa=0.5, best_epoch=2, step=9),
                    "tonet", dict(attn_dim=32))
    state, family, kw = restore_checkpoint(tmp_path / "c.pt")
    assert family == "tonet" and kw == dict(attn_dim=32)
    assert (state.voicing_threshold, state.epoch, state.best_epoch, state.step) == (0.3, 4, 2, 9)
    for k, v in {**params, **batch_stats}.items():
        assert torch.equal(v, {**state.params, **state.batch_stats}[k]), k
    again, _, _ = init_model(cfg, dict(attn_dim=32), seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="not a"):
        torch.save({"x": torch.zeros(1)}, tmp_path / "bad.pt")
        restore_checkpoint(tmp_path / "bad.pt")


def test_snippets_and_track_match_jax(rng):
    spec = rng.normal(size=(35, 2)).astype(np.float32)
    notes = rng.random(35).astype(np.float32)
    for a, b in zip(TSN.chunk_fixed(spec, notes, 16), JSN.chunk_fixed(spec, notes, 16)):
        np.testing.assert_array_equal(a, b)
    assert TSN.gen_split_list(35, 16) == JSN.gen_split_list(35, 16)

    class DS:
        def __init__(self, cls):
            self.tracks = [cls(f"t{i}", spec[: 35 - i * 10], notes[: 35 - i * 10], spec[:0], spec[:0])
                           for i in range(3)]

    got = list(TSN.inference_snippets(DS(Track), 16))
    want = list(JSN.inference_snippets(DS(JTrack), 16))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert [t.num_frames for t in DS(Track).tracks] == [35, 25, 15]


def test_labels_match_jax(tmp_path, monkeypatch):
    """Each label reader on the same files: equal arrays."""
    hop = TL.HOP_256
    n = 50
    times = np.arange(n) * hop
    freqs = np.where(np.arange(n) % 4 == 0, 0.0, 220.0)
    np.savetxt(tmp_path / "daisy1REF.txt", np.stack([times, freqs], 1))
    np.savetxt(tmp_path / "Song_MELODY2.csv", np.stack([times, freqs], 1), delimiter=",")
    t10 = np.arange(100) * 0.01
    f10 = np.where(np.arange(100) < 10, 0.0, 330.0)
    np.savetxt(tmp_path / "train01REF.txt", np.stack([t10, f10], 1))
    (tmp_path / "PitchLabel").mkdir()
    np.savetxt(tmp_path / "PitchLabel" / "abjones_1.pv", np.where(np.arange(40) % 3 == 0, 0.0, 60.0))
    (tmp_path / "f0ref").mkdir()
    with open(tmp_path / "f0ref" / "Song_MIX.txt", "w") as fh:
        for k, f in enumerate([0.0, 220.0, 220.0, 0.0, 440.0]):
            fh.write(f"{float(k * 0.01)!r} {float(f)!r}\n")
    mel = tmp_path / "popular" / "AIST.RWC-MDB-P-2001.MELODY"
    mel.mkdir(parents=True)
    with open(mel / "RM-P001.MELODY.TXT", "w") as fh:
        for i in range(10, 50):
            fh.write(f"{i} {i} m 220.0 0\n")
    monkeypatch.setenv("fatnet_spec", str(tmp_path))
    root = str(tmp_path)
    mask = np.zeros(n, bool)
    mask[10:30] = True
    pairs = [
        (TL.adc04_label("daisy1", root=root), JL.adc04_label("daisy1", root=root)),
        (TL.mirex05_label("train01", root=root), JL.mirex05_label("train01", root=root)),
        (TL.mir1k_label("abjones_1", 39 * 320 + 640, root=root),
         JL.mir1k_label("abjones_1", 39 * 320 + 640, root=root)),
        (TL.medleydb_label("Song", mask, melody2_dir=root),
         JL.medleydb_label("Song", mask, melody2_dir=root)),
        (TL.tonet_f0ref_label("Song"), JL.tonet_f0ref_label("Song")),
        (TL.rwc_label(0, 60, root=root), JL.rwc_label(0, 60, root=root)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got["notes"], want["notes"])
        for k in ("times", "freqs"):
            np.testing.assert_array_equal(got["original"][k], want["original"][k])
    notes = np.where(np.arange(300) < 30, 0.0, 60.0).astype(np.float32)
    np.testing.assert_array_equal(TL.resample_notes_to_10ms(notes), JL.resample_notes_to_10ms(notes))
    with pytest.raises(ValueError):
        TL.validity_check_of_ref_freqs(np.array([5.0]))


@pytest.mark.parametrize("family", ["tonet", "dcnet"])
def test_hmm_artifacts_main_matches_jax(tmp_path, rng, family):
    """cli/hmm_artifacts.py main on the same note files: the five .dat
    artifacts byte-equal to the JAX CLI's (tonet resamples to 10 ms; dcnet
    with its hard-coded switch matrix)."""
    paths = []
    for i in range(2):
        notes = np.where(rng.random(900) < 0.25, 0.0, rng.uniform(40, 80, 900)).astype(np.float32)
        paths.append(tmp_path / f"n{i}.npy")
        np.save(paths[-1], notes)
    extra = ["--dcnet-switch"] if family == "dcnet" else []
    args = ["--family", family, "--notes", *map(str, paths)] + extra
    TH.main(args + ["--out", str(tmp_path / "t")])
    JH.main(args + ["--out", str(tmp_path / "j")])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 5 and names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
