"""The plain reference against brute force and loops, on tiny cases."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from perfbench import hmm_params
from perfbench.reference import decode as ref
from perfbench.reference.precision import CONTROL


def brute_force(log_B, log_pi, log_obs):
    """The best path by enumeration; ties to the lexicographically first."""
    T, S = log_obs.shape
    best, arg = -np.inf, None
    for path in itertools.product(range(S), repeat=T):
        score = log_pi[path[0]] + log_obs[0, path[0]]
        for t in range(1, T):
            score += log_B[path[t], path[t - 1]] + log_obs[t, path[t]]
        if score > best:
            best, arg = score, path
    return np.array(arg), best


@pytest.mark.parametrize("seed", range(6))
def test_viterbi_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    S, T = 3, 6
    A = rng.random((S, S)) + 0.05
    A /= A.sum(axis=1, keepdims=True)
    pi = rng.random(S) + 0.05
    pi /= pi.sum()
    log_B, log_pi = ref.log_params(A, pi)
    obs = np.log(rng.random((T, S)).astype(np.float32) + 1e-3).astype(np.float32)
    want, score = brute_force(log_B.astype(np.float64), log_pi.astype(np.float64), obs.astype(np.float64))
    got = ref.viterbi(torch.from_numpy(log_B), torch.from_numpy(log_pi), [torch.from_numpy(obs)])[0]
    assert np.array_equal(got.numpy(), want)
    assert ref.path_score(torch.from_numpy(log_B), torch.from_numpy(log_pi), torch.from_numpy(obs),
                          got) == pytest.approx(score, rel=1e-6)


def test_viterbi_decodes_tracks_of_different_lengths_alone():
    rng = np.random.default_rng(9)
    A, pi = hmm_params.shaped_hmm(12, 3, 2, None, seed=4, frames=2000)
    log_B, log_pi = (torch.from_numpy(x) for x in ref.log_params(A, pi))
    obs = [torch.from_numpy(np.log(rng.random((n, 13)).astype(np.float32))) for n in (7, 19, 1)]
    together = ref.viterbi(log_B, log_pi, obs)
    for o, p in zip(obs, together):
        assert torch.equal(p, ref.viterbi(log_B, log_pi, [o])[0])


def test_path_gap_is_zero_for_the_best_path_and_positive_off_it():
    rng = np.random.default_rng(1)
    A, pi = hmm_params.shaped_hmm(20, 4, 2, None, seed=2, frames=2000)
    log_B, log_pi = (torch.from_numpy(x) for x in ref.log_params(A, pi))
    obs = torch.from_numpy(np.log(rng.random((50, 21)).astype(np.float32)))
    best = ref.viterbi(log_B, log_pi, [obs])[0]
    assert ref.path_gap(log_B, log_pi, obs, best, best) == 0.0
    moved = best.clone()
    moved[10] = (moved[10] + 7) % 21
    assert ref.path_gap(log_B, log_pi, obs, best, moved) > 0.0
    assert ref.path_gap(log_B, log_pi, obs, best, best[:-1]) == float("inf")


def test_find_peaks_is_the_first_maximum_of_the_reflected_window():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (30, 17)).astype(np.float32)  # many ties
    spw = 3
    got = ref.find_peaks(torch.from_numpy(x), spw).numpy()
    pad = np.pad(x, ((0, 0), (spw, spw)), mode="reflect")
    for t in range(30):
        for b in range(17):
            w = pad[t, b: b + 2 * spw + 1]
            assert got[t, b] == (int(np.argmax(w)) == spw)


def test_shaun_observations_sum_to_one_and_the_control_differs():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(-4, 1, (64, 40)).astype(np.float32))
    logits[:, 11] += 8
    log_obs = ref.shaun_log_obs(logits, float(np.log(0.32 / 0.68)), 5)
    assert torch.allclose(log_obs.exp().sum(dim=1), torch.ones(64), atol=1e-5)
    assert log_obs[:, 11].exp().min() > 0.5
    control = ref.shaun_log_obs(logits, float(np.log(0.32 / 0.68)), 5, precision=CONTROL)
    assert not torch.equal(control, log_obs)


def test_shaped_hmm_is_row_stochastic_and_banded():
    A, pi = hmm_params.shaped_hmm(40, 5, 2, [[0.9, 0.1], [0.2, 0.8]], seed=8, frames=3000)
    assert np.allclose(A.sum(axis=1), 1.0, atol=1e-6) and np.isclose(pi.sum(), 1.0)
    i, j = np.indices((40, 40))
    assert (A[:40, :40][np.abs(i - j) > 5] == 0).all()
    assert np.allclose(A[:40, 40], 0.1) and np.allclose(A[40, 40], 0.8)
