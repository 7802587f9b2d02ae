"""The port's dense path (hmm/viterbi_dense.py of viterbi_spl_tpu_torch):
the plain versions of K3/K4 against the JAX package's Pallas kernels in
interpret mode and the NumPy oracle, and the batched decode API's dispatch.
The CUDA kernels against their plain versions: tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_hmm
from viterbi_spl_tpu.hmm.viterbi import NEG_PAD
from viterbi_spl_tpu.hmm.viterbi import prepare_log_params as jax_prepare
from viterbi_spl_tpu.hmm.viterbi_pallas import (
    viterbi_backtrace_pallas_batch,
    viterbi_forward_pallas_batch,
)
from viterbi_spl_tpu_torch.hmm import params as TP
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TD
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle, viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params

TINY = np.finfo(np.float32).tiny


def _batch(rng, A, N, T):
    S = A.shape[0]
    obs = np.stack([random_hmm(rng, S, T, sparse_obs=True)[2].T for _ in range(N)])
    obs[-1] = 1.0 / S  # tie-heavy track: first-max everywhere
    return np.log(obs + TINY).astype(np.float32)


@pytest.mark.parametrize("S,P", [(90, 128), (361, 384)])
def test_plain_k3_k4_bitwise_equal_pallas_and_oracle(rng, S, P):
    A, pi, _ = random_hmm(rng, S, 8)
    log_B, log_pi = prepare_log_params(A, pi)
    N_j, T = 8, 48
    lens = np.array([48, 30, 1, 48, 17, 48, 48, 48], np.int32)
    log_obs = _batch(rng, A, N_j, T)
    log_B_p, log_pi_p = jax_prepare(A, pi, pad_to=P)
    padded = np.full((N_j, T, P), NEG_PAD, np.float32)
    padded[:, :, :S] = log_obs
    t1_j, t1m1_j = viterbi_forward_pallas_batch(
        jnp.asarray(log_B_p), jnp.asarray(log_pi_p), jnp.asarray(padded), lens,
        block_frames=16, interpret=True,
    )
    last = jnp.argmax(t1_j[:, :S], axis=1).astype(jnp.int32)
    st_j = np.asarray(viterbi_backtrace_pallas_batch(
        t1m1_j, jnp.asarray(log_B_p), last, lens, block_frames=16, interpret=True,
    ))
    t1_j, t1m1_j = np.asarray(t1_j), np.asarray(t1m1_j)

    N = 5  # not a multiple of 8
    launches = (TD.dense_forward.launches, TD.dense_backtrace.launches)
    t1_t, t1m1_t = TD.dense_forward(log_B, log_pi, torch.from_numpy(log_obs[:N]), lens[:N])
    np.testing.assert_array_equal(t1_t.numpy(), t1_j[:N, :S])
    last_t = torch.argmax(t1_t, dim=1).to(torch.int32)
    st_t = TD.dense_backtrace(log_B, t1m1_t, last_t, lens[:N]).numpy()
    for n in range(N):
        L = lens[n]
        np.testing.assert_array_equal(t1m1_t[n, :L].numpy(), t1m1_j[n, :L, :S])
        np.testing.assert_array_equal(st_t[n, :L], st_j[n, :L])
        np.testing.assert_array_equal(
            st_t[n, :L], viterbi_oracle_log(log_B, log_pi, log_obs[n, :L])
        )
    assert (TD.dense_forward.launches, TD.dense_backtrace.launches) == launches


@pytest.mark.parametrize("banded", [True, False])
def test_decode_api_dispatch_matches_oracle(rng, banded):
    """The batched decode API on the CPU: the banded dispatch for a shaped
    matrix, the dense one for a random matrix — ragged tracks, paths equal
    to the oracle."""
    if banded:
        n_bins = 60
        walk = [np.clip(30 + np.cumsum(rng.integers(-2, 3, 2000)), 0, n_bins - 1)]
        stats = TP.count_statistics(walk, n_bins)
        A = TP.shape_transition_matrix(
            stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]),
            n_bins, 6, 2,
        )
        pi = TP.shape_init_probs(stats.p_steady, p_th=1e-4)
    else:
        A, pi, _ = random_hmm(rng, 40, 8)
    S = A.shape[0]
    tracks = [random_hmm(rng, S, T, sparse_obs=True)[2] for T in (33, 1, 70)]
    got = TD.viterbi_decode_batch(
        transition_matrix=A, prob_init=pi, probs_st_list=tracks, device="cpu"
    )
    for obs, g in zip(tracks, got):
        np.testing.assert_array_equal(
            g, viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs)
        )
