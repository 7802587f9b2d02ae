"""The port's observation models (hmm/obs.py of viterbi_spl_tpu_torch)
against the JAX package's on the same logits: exact peak masks,
probabilities within float32 ulps, and equal decoded paths on tie-free
logits.

Tolerance: rtol=1e-5, atol=1e-30. XLA and PyTorch compute f32 exp and
sigmoid to within a few ulps of each other, and sum the softmax
denominators in different orders; 1e-5 is about 80 ulps of float32.
"""

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.hmm import obs as JO
from viterbi_spl_tpu_torch.hmm import obs as TO
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle
from viterbi_spl_tpu_torch.hmm import params as TP

RTOL, ATOL = 1e-5, 1e-30


@pytest.mark.parametrize("spw,n_bins,quantized", [
    (5, 320, False), (16, 721, False), (20, 721, False), (3, 97, True),
])
def test_find_peaks_masks_equal(rng, spw, n_bins, quantized):
    if quantized:  # coarse values: many windowed ties
        logits = rng.integers(0, 3, (60, n_bins)).astype(np.float32)
    else:
        logits = rng.normal(size=(40, n_bins)).astype(np.float32)
    got = TO.find_peaks(torch.from_numpy(logits), spw).numpy()
    np.testing.assert_array_equal(got, np.asarray(JO.find_peaks(logits, spw)))


@pytest.mark.parametrize("spw,n_bins,th", [(5, 360, 0.32), (16, 721, 0.34), (20, 721, 2.442347)])
def test_shaun_probs_agree(rng, spw, n_bins, th):
    logits = rng.normal(size=(30, n_bins)).astype(np.float32) * 3
    logits[3] = 0.0  # a frame with a single (first-bin) peak
    threshold = float(np.log(th / (1 - th))) if 0 < th < 1 else th
    got = TO.shaun_observation_probs(torch.from_numpy(logits), threshold, spw).numpy()
    want = np.asarray(JO.shaun_observation_probs(logits, threshold, spw))
    assert got.shape == want.shape == (30, n_bins + 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scaled", [False, True])
def test_softmax_probs_agree(rng, scaled):
    n_bins, T, spw = 360, 25, 5
    logits = rng.normal(size=(T, n_bins)).astype(np.float32) * 2
    pi = rng.random(n_bins + 1) + 0.5
    pi = (pi / pi.sum()).astype(np.float32)
    vth = float(np.log(0.54 / 0.46))
    got = TO.softmax_observation_probs(torch.from_numpy(logits), vth, pi, spw, scaled).numpy()
    want = np.asarray(JO.softmax_observation_probs(logits, vth, pi, spw, scaled))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rereference(rng):
    logits = rng.normal(size=(10, 361)).astype(np.float32)
    np.testing.assert_array_equal(
        TO.rereference_softmax_logits(torch.from_numpy(logits)).numpy(),
        np.asarray(JO.rereference_softmax_logits(logits)),
    )


@pytest.mark.parametrize("method", ["shaun", "softmax-scaled", "softmax-unscaled"])
def test_decoded_paths_equal_on_tie_free_logits(rng, method):
    """Both packages' observations decode to the same path (tie-free
    logits: a clear melody line over noise)."""
    n_bins, T = 60, 80
    path = np.clip(30 + np.cumsum(rng.integers(-1, 2, T)), 0, n_bins - 1)
    logits = rng.normal(-2, 1, (T, n_bins)).astype(np.float32)
    logits[np.arange(T), path] += 5.0
    tracks = [np.concatenate([rng.integers(0, n_bins, 50), [n_bins] * 10])]
    stats = TP.count_statistics(tracks, n_bins)
    A = TP.shape_transition_matrix(
        stats.transition_counts, np.array([[0.95, 0.05], [0.1, 0.9]]), n_bins, 5, 2
    )
    pi = TP.shape_init_probs(stats.p_steady)
    if method == "shaun":
        got = TO.shaun_observation_probs(torch.from_numpy(logits), 0.2, 3).numpy()
        want = np.asarray(JO.shaun_observation_probs(logits, 0.2, 3))
    else:
        scaled = method == "softmax-scaled"
        got = TO.softmax_observation_probs(torch.from_numpy(logits), 0.2, pi, 3, scaled).numpy()
        want = np.asarray(JO.softmax_observation_probs(logits, 0.2, pi, 3, scaled))
    np.testing.assert_array_equal(
        viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=got.T),
        viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=want.T),
    )
