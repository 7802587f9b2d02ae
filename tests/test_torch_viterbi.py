"""The port's host tables and plain decoder (hmm/viterbi.py and
hmm/oracle.py of viterbi_spl_tpu_torch) against the JAX package and the
NumPy oracle: paths must be bit-identical."""

import numpy as np
import pytest
import torch

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.hmm import oracle as JO
from viterbi_spl_tpu.hmm.viterbi import prepare_log_params as jax_prepare
from viterbi_spl_tpu.hmm.viterbi import viterbi_decode_jax
from viterbi_spl_tpu_torch.hmm import oracle as TO
from viterbi_spl_tpu_torch.hmm.viterbi import (
    NEG_PAD,
    TINY,
    first_argmax,
    log_obs_fn,
    prepare_log_params,
    viterbi_decode_batch_plain,
)


@pytest.mark.parametrize("pad_to", [None, 384])
def test_prepare_log_params_bitwise(rng, pad_to):
    A, pi, _ = random_hmm(rng, 361, 4)
    got = prepare_log_params(A, pi, pad_to=pad_to)
    want = jax_prepare(A, pi, pad_to=pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert TINY == np.finfo(np.float32).tiny and NEG_PAD == np.float32(-1e30)


@pytest.mark.parametrize("S,T", [(321, 90), (361, 70), (722, 40)])
def test_plain_decoder_matches_oracle_and_jax(rng, S, T):
    A, pi, _ = random_hmm(rng, S, 4)
    tracks = [random_hmm(rng, S, T, sparse_obs=True)[2] for _ in range(2)]
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = np.stack([np.log(o.T + TINY) for o in tracks]).astype(np.float32)
    got = viterbi_decode_batch_plain(
        torch.from_numpy(log_B), torch.from_numpy(log_pi), torch.from_numpy(log_obs)
    ).numpy()
    for obs, g in zip(tracks, got):
        oracle = JO.viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs)
        np.testing.assert_array_equal(g, oracle)
        np.testing.assert_array_equal(
            g, viterbi_decode_jax(transition_matrix=A, prob_init=pi, probs_st=obs)
        )
        # the port's own oracle copy agrees with the JAX package's
        np.testing.assert_array_equal(
            TO.viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs), oracle
        )


def test_oracle_forward_tables_equal(rng):
    A, pi, obs = random_hmm(rng, 67, 40)
    for got, want in zip(
        TO.viterbi_oracle_forward(transition_matrix=A, prob_init=pi, probs_st=obs),
        JO.viterbi_oracle_forward(transition_matrix=A, prob_init=pi, probs_st=obs),
    ):
        np.testing.assert_array_equal(got, want)


def test_first_max_tie_breaking():
    S = 4
    A = np.full((S, S), 1.0 / S, np.float32)
    pi = np.full((S,), 1.0 / S)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = log_obs_fn(torch.full((1, 10, S), 1.0 / S))
    got = viterbi_decode_batch_plain(torch.from_numpy(log_B), torch.from_numpy(log_pi), log_obs)
    assert torch.all(got == 0)
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert first_argmax(x, dim=1).tolist() == [1, 0]
