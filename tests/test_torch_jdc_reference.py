"""The port's JDC chain (frontend/stft.py::jdc_spectrogram, models/jdc.py)
against the benchmark's plain reference (perfbench/reference/stft.py,
jdc.py), on the CPU, with weights made from a seed by the benchmark's
jdc_weights (make_weights, the LSTMs' kernels drawn alike, and BatchNorm's
running averages, scales and offsets and every bias drawn off their
defaults), and the chain's spans and counters on one traced clip.

Tolerances and why:
- the model, eval mode, on a clip of 3 chunks: the pitch output, the
  voicing output and the re-referenced logits each within 1e-4 of the
  reference's largest magnitude. Both sides compute in float32 and differ
  only in summation order (the same convolutions, torch's LSTM against the
  gate equations written out): up to 6e-7 of the largest magnitude here.
  bfloat16 keeps 8 bits of mantissa, and either side run in it is 1e-3 to
  1e-2 off, which the tests below show fails the tolerance. A program that
  drops one term (BatchNorm's running mean, variance, scale or offset, the
  dense layers' biases or the LSTMs' bias) is 0.26 to 0.71 off, and so is
  shown to fail it too.
- the spectrogram: within 1e-6 of the output's range, as
  tests/test_torch_frontend.py holds the front ends (both in float64 from
  the same float32 window; the float32 STFT of the benchmark's control is
  4e-5 off, beyond it).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import hmm_params
from perfbench import traffic as T
from perfbench.reference import jdc as R
from perfbench.reference import stft as RS
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch import tracing
from viterbi_spl_tpu_torch.frontend import jdc_spectrogram
from viterbi_spl_tpu_torch.models.jdc import JDC

SEED = 4294967311
TOL = 1e-4  # of the reference's largest magnitude (see the module docstring)
CPU = torch.device("cpu")


def gap(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def weights():
    return R.jdc_weights(SEED, CPU)


@pytest.fixture(scope="module")
def clip():
    """A 0.7 s clip's spectrogram in 3 chunks of 31 frames, [3, 31, 513]."""
    feat = jdc_spectrogram(T.melody_audio(0.7, 8000, T.sub_seed(SEED, 7), CPU), device=CPU)
    return torch.from_numpy(np.pad(feat, ((0, 93 - len(feat)), (0, 0)))).view(3, 31, 513)


def program(weights, dtype=torch.float32):
    with torch.device("meta"):
        model = JDC(dtype=dtype)
    model = model.to_empty(device=CPU)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def reference(weights):
    with torch.device("meta"):
        model = R.JDC()
    model = model.to_empty(device=CPU)
    model.load_state_dict(weights, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def want(weights, clip):
    with torch.no_grad():
        return reference(weights)(clip)


def gaps(out, want) -> dict:
    return {"pitch": gap(out["pitch"], want["pitch"]),
            "voicing": gap(out["voicing"], want["voicing"]),
            "logits": gap(R.pitch_logits(out), R.pitch_logits(want))}


def test_jdc_matches_the_plain_reference(weights, clip, want):
    with torch.no_grad():
        out = program(weights)(clip)
    assert out["pitch"].shape == (3, 31, 722) and out["voicing"].shape == (3, 31)
    # the LSTMs' kernels are drawn: a zero LSTM would give logits of 0
    assert float(R.pitch_logits(want).std()) > 0.05
    assert all(g <= TOL for g in gaps(out, want).values()), gaps(out, want)


@pytest.mark.parametrize("side", ["program", "reference"])
def test_either_side_in_bfloat16_fails_the_tolerance(weights, clip, want, side):
    with torch.no_grad():
        if side == "program":
            out = program(weights, torch.bfloat16)(clip)
        else:
            out = reference(weights).to(torch.bfloat16)(clip.to(torch.bfloat16))
    assert max(gaps(out, want).values()) > TOL, gaps(out, want)


def _is_bn(key: str, leaf: str) -> bool:
    parts = key.split(".")
    return parts[-1] == leaf and "bn" in parts[-2]


DROPPED = {  # a term a program could leave out -> (its keys, the value it reads as)
    "running_mean": (lambda k: _is_bn(k, "mean"), 0.0),
    "running_var": (lambda k: _is_bn(k, "var"), 1.0),
    "bn_scale": (lambda k: _is_bn(k, "scale"), 1.0),
    "bn_offset": (lambda k: _is_bn(k, "bias"), 0.0),
    "dense_bias": (lambda k: k.endswith("dense.bias"), 0.0),
    "lstm_bias": (lambda k: ".bias_hh_l0" in k, 0.0),
}


@pytest.mark.parametrize("term", sorted(DROPPED))
def test_a_program_that_drops_a_term_fails_the_tolerance(weights, clip, want, term):
    """jdc_weights draws every term off its default, so a program that
    ignores one (here: the program loaded with that term at its default)
    reads far off the reference."""
    hit, default = DROPPED[term]
    keys = [k for k in weights if hit(k)]
    assert keys and all(float((weights[k] - default).abs().max()) > 0.05 for k in keys), term
    with torch.no_grad():
        out = program({k: torch.full_like(v, default) if k in keys else v
                       for k, v in weights.items()})(clip)
    assert max(gaps(out, want).values()) > TOL, gaps(out, want)


def test_jdc_spectrogram_matches_the_plain_reference():
    samples = T.melody_audio(1.3, 8000, T.sub_seed(SEED, 3), CPU)
    got = jdc_spectrogram(samples, device=CPU)
    want = RS.jdc_spectrogram(samples, CPU).numpy()
    assert got.shape == want.shape == (1 + len(samples) // 80, 513)
    span = float(want.max() - want.min())
    assert np.abs(got - want).max() <= 1e-6 * span
    control = RS.jdc_spectrogram(samples, CPU, "control").numpy()
    assert np.abs(control - want).max() > 1e-6 * span


def test_a_traced_clip_records_the_jdc_spans_and_counts_the_front_ends_copies(weights,
                                                                              monkeypatch):
    """cli/transcribe's chain on one short clip under the tracer. On the CPU
    no copy crosses to a card, so tracing.upload and to_host are watched:
    each call is made as it would be from a card, inside a `<layer>.wait`
    span counting one host_waits."""
    from viterbi_spl_tpu_torch.apps import jdc as jdc_app
    from viterbi_spl_tpu_torch.apps.common import model_logits_for_dataset
    from viterbi_spl_tpu_torch.cli.transcribe import _WavDataset, features_from_samples
    from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup

    calls = []

    def as_from_a_card(real, at):
        def watched(*args, **kwargs):
            layer = kwargs["layer"] if "layer" in kwargs else args[at]
            calls.append((real.__name__, layer))
            with tracing.wait(layer):
                return real(*args, **kwargs)
        return watched

    for name, at in (("upload", 2), ("to_host", 1)):
        monkeypatch.setattr(tracing, name, as_from_a_card(getattr(tracing, name), at))
    A, pi = hmm_params.shaped_hmm(721, 40, 2, [[0.9779, 0.0221], [0.0172, 0.9828]], SEED)
    setup = DecoderSetup(transition_matrix=A, init_probs=pi, n_bins=721, note_min=38.0,
                         bins_per_semitone=16.0, spw=16, voicing_threshold=0.01,
                         hop_seconds=0.01, device="cpu")
    model = program(weights)
    samples = T.melody_audio(0.4, 8000, T.sub_seed(SEED, 5), CPU)
    tracing.clear()
    with tracing.enabled():
        feat = features_from_samples("jdc", samples, device=CPU)
        logits = model_logits_for_dataset(jdc_app.config(), model, _WavDataset(["clip"], [feat]))
        voiced, bins = setup.decode_batch(logits)[0]
    spans = tracing.spans()
    tracing.clear()
    names = [s.name for s in spans]
    for name in ("front_end.setup", "front_end.stft", "front_end.db", "front_end.wait",
                 "model.convs"):
        assert name in names, name
    assert sorted(s.attrs["head"] for s in spans if s.name == "model.recurrent") == [
        "pitch", "voicing"]
    name_of = {s.id: s.name for s in spans}
    waits = [s for s in spans if s.name == "front_end.wait"]
    # the window's and the samples' uploads, the magnitude's copy back
    assert [c for c in calls if c[1] == "front_end"] == [("upload", "front_end")] * 2 + [
        ("to_host", "front_end")]
    assert sum(s.counts.get("host_waits", 0) for s in waits) == 3
    assert {name_of[s.parent] for s in waits} == {"front_end", "front_end.setup"}
    assert logits[0].shape == (41, 721) and voiced.shape == bins.shape == (41,)
