"""The CUDA kernels K1-K4 against their plain PyTorch versions on the card:
exact equality of t1_last, of t1m1 up to each track's length, and of the
decoded states, with ragged lengths and N not a multiple of 8.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so that it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from viterbi_spl_tpu_torch.hmm import params as TP
from viterbi_spl_tpu_torch.hmm import viterbi_banded as TB
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TD
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.viterbi import log_obs_fn, prepare_log_params

LENGTHS = np.array([96, 50, 1, 77, 96, 13], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the CUDA kernel with its plain version")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


def _log_obs(rng, N, T, S):
    obs = rng.random((N, T, S)).astype(np.float32) ** 6
    obs /= obs.sum(2, keepdims=True)
    obs[-2] = 1.0 / S  # tie-heavy tracks: first-max everywhere
    obs[-1] = obs[-1, 0:1]
    return torch.from_numpy(np.log(obs + np.finfo(np.float32).tiny).astype(np.float32))


def _check(t1_k, t1m1_k, st_k, t1_p, t1m1_p, st_p, lengths):
    np.testing.assert_array_equal(t1_k.cpu().numpy(), t1_p.numpy())
    for n, L in enumerate(lengths):
        np.testing.assert_array_equal(t1m1_k[n, :L].cpu().numpy(), t1m1_p[n, :L].numpy())
        np.testing.assert_array_equal(st_k[n, :L].cpu().numpy(), st_p[n, :L].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,d_max", [(360, 14), (721, 40)])
def test_cuda_k1_k2_match_plain(cuda, rng, n_bins, d_max):
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 4000)), 0, n_bins - 1)]
    stats = TP.count_statistics(walk, n_bins)
    A = TP.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]), n_bins, d_max, 2
    )
    pi = TP.shape_init_probs(stats.p_steady, p_th=1e-4)
    log_B, log_pi = prepare_log_params(A, pi)
    bs = TB.extract_banded_structure(A)
    log_obs = _log_obs(rng, len(LENGTHS), 96, n_bins + 1)
    launches = TB.banded_forward.launches
    t1_p, t1m1_p = TB.banded_forward_plain(bs, torch.from_numpy(log_pi), log_obs, LENGTHS)
    t1_k, t1m1_k = TB.banded_forward(bs, log_pi, log_obs.to(cuda), LENGTHS)
    assert TB.banded_forward.launches == launches + 1
    last = torch.argmax(t1_p, dim=1).to(torch.int32)
    st_p = TB.banded_backtrace_plain(bs, t1m1_p, last, LENGTHS)
    st_k = TB.banded_backtrace(bs, t1m1_k, last.to(cuda), LENGTHS)
    torch.cuda.synchronize()
    _check(t1_k, t1m1_k, st_k, t1_p, t1m1_p, st_p, LENGTHS)
    np.testing.assert_array_equal(
        st_k[0].cpu().numpy(), viterbi_oracle_log(log_B, log_pi, log_obs[0].numpy())
    )


@pytest.mark.gpu
@pytest.mark.parametrize("S", [361, 722])
def test_cuda_k3_k4_match_plain(cuda, rng, S):
    if S == 722:
        A, pi = TP.imm_transition_matrix(20, 721), np.full(S, 1.0 / S)
    else:
        A = rng.random((S, S)).astype(np.float32) ** 4
        A /= A.sum(1, keepdims=True)
        pi = np.full(S, 1.0 / S)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = _log_obs(rng, len(LENGTHS), 96, S)
    lB, lpi = torch.from_numpy(log_B), torch.from_numpy(log_pi)
    launches = TD.dense_forward.launches
    t1_p, t1m1_p = TD.dense_forward_plain(lB, lpi, log_obs, LENGTHS)
    t1_k, t1m1_k = TD.dense_forward(log_B, log_pi, log_obs.to(cuda), LENGTHS)
    assert TD.dense_forward.launches == launches + 1
    last = torch.argmax(t1_p, dim=1).to(torch.int32)
    st_p = TD.dense_backtrace_plain(lB, t1m1_p, last, LENGTHS)
    st_k = TD.dense_backtrace(log_B, t1m1_k, last.to(cuda), LENGTHS)
    torch.cuda.synchronize()
    _check(t1_k, t1m1_k, st_k, t1_p, t1m1_p, st_p, LENGTHS)
    np.testing.assert_array_equal(
        st_k[0].cpu().numpy(), viterbi_oracle_log(log_B, log_pi, log_obs[0].numpy())
    )


@pytest.mark.gpu
def test_decode_api_runs_the_kernels(cuda, rng):
    """The batched decode API on the card launches K1/K2 for a shaped
    matrix and K3/K4 for a dense one; paths equal the oracle on the log
    observations the card computes."""
    n_bins = 120
    walk = [np.clip(60 + np.cumsum(rng.integers(-2, 3, 3000)), 0, n_bins - 1)]
    stats = TP.count_statistics(walk, n_bins)
    shaped = TP.shape_transition_matrix(
        stats.transition_counts, np.array([[0.97, 0.03], [0.05, 0.95]]), n_bins, 8, 2
    )
    pi = TP.shape_init_probs(stats.p_steady, p_th=1e-4)
    dense = TP.imm_transition_matrix(4, n_bins)
    tracks = []
    for T in (70, 1, 33):
        obs = rng.random((n_bins + 1, T)).astype(np.float32) ** 6
        tracks.append(obs / obs.sum(0, keepdims=True))
    for A, kernels in ((shaped, ("K1", "K2")), (dense, ("K3", "K4"))):
        before = {k: TD.KERNEL_WRAPPERS[k].launches for k in kernels}
        got = TD.viterbi_decode_batch(
            transition_matrix=A, prob_init=pi, probs_st_list=tracks, device=cuda
        )
        log_B, log_pi = prepare_log_params(A, pi)
        for g, obs in zip(got, tracks):
            log_obs = log_obs_fn(torch.from_numpy(obs.T.copy()).to(cuda)).cpu().numpy()
            np.testing.assert_array_equal(g, viterbi_oracle_log(log_B, log_pi, log_obs))
        for k in kernels:
            assert TD.KERNEL_WRAPPERS[k].launches == before[k] + 1, k
