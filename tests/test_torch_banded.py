"""The port's banded path (hmm/viterbi_banded.py of viterbi_spl_tpu_torch)
against the JAX package: shaped matrices, the extracted structure, and the
plain versions of K1/K2 against the Pallas kernels in interpret mode and
the NumPy oracle. The CUDA kernels against their plain versions:
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.hmm import viterbi_banded as JB
from viterbi_spl_tpu.hmm.viterbi import NEG_PAD
from viterbi_spl_tpu_torch.hmm import params as TP
from viterbi_spl_tpu_torch.hmm import viterbi_banded as TB
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params


def _tracks(rng, n_bins, n=3000, step=3):
    walk = np.clip(n_bins // 2 + np.cumsum(rng.integers(-step, step + 1, n)), 0, n_bins - 1)
    voiced = np.repeat(rng.random(n // 20 + 1) > 0.3, 20)[:n]
    return [np.where(voiced, walk, n_bins)]


def _shaped(params, tracks, n_bins, d_max, floor=2):
    stats = params.count_statistics(tracks, n_bins)
    A = params.shape_transition_matrix(
        stats.transition_counts, stats.switch, n_bins, d_max, floor
    )
    pi = params.shape_init_probs(stats.p_steady, p_th=1e-4)
    return A, pi, stats


@pytest.mark.parametrize("n_bins,d_max,floor", [(320, 12, 6), (360, 14, 2), (721, 40, 2)])
def test_shaped_matrices_bitwise_equal(rng, n_bins, d_max, floor):
    tracks = _tracks(rng, n_bins)
    A_t, pi_t, st_t = _shaped(TP, tracks, n_bins, d_max, floor)
    A_j, pi_j, st_j = _shaped(JP, tracks, n_bins, d_max, floor)
    assert A_t.dtype == A_j.dtype and pi_t.dtype == pi_j.dtype
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(pi_t, pi_j)
    np.testing.assert_array_equal(st_t.transition_counts, st_j.transition_counts)
    np.testing.assert_array_equal(st_t.switch, st_j.switch)
    assert TP.single_side_d_max(0.01, 60) == JP.single_side_d_max(0.01, 60) == 14
    np.testing.assert_array_equal(
        TP.imm_transition_matrix(20, n_bins), JP.imm_transition_matrix(20, n_bins)
    )


@pytest.mark.parametrize("n_bins,d_max,pad_to", [(360, 14, 384), (721, 40, 768)])
def test_structure_fields_equal_jax(rng, n_bins, d_max, pad_to):
    A, _, _ = _shaped(TP, _tracks(rng, n_bins), n_bins, d_max)
    bt = TB.extract_banded_structure(A, pad_to)
    bj = JB.extract_banded_structure(A, pad_to)
    assert bt is not None and bj is not None
    for f in ("d_max", "n_bins", "S", "P", "log_c_uv", "log_c_vu", "log_c_uu", "classes"):
        assert getattr(bt, f) == getattr(bj, f), f
    np.testing.assert_array_equal(bt.band, bj.band)
    np.testing.assert_array_equal(bt.bv, bj.bv)
    assert TB._doubling_stages(2 * d_max + 1) == JB._doubling_stages(2 * d_max + 1)
    # unpadded (the port's own decode) gives the same classes and values
    b0 = TB.extract_banded_structure(A)
    assert b0.P == n_bins + 1 and b0.classes == bj.classes
    np.testing.assert_array_equal(b0.bv, bj.bv[:, : n_bins + 1])


def test_structure_absent_for_dense_matrices(rng):
    assert TB.extract_banded_structure(TP.imm_transition_matrix(20, 721)) is None
    assert TB.extract_banded_structure(TP.imm_transition_matrix(4, 40), 128) is None
    R = rng.random((20, 20)).astype(np.float32)
    R /= R.sum(1, keepdims=True)
    assert TB.extract_banded_structure(R) is None


def _log_obs(rng, N, T, S, tie_tracks=True):
    obs = rng.random((N, T, S)).astype(np.float32) ** 6
    obs /= obs.sum(2, keepdims=True)
    if tie_tracks:
        # constant observations force equal-max candidates (first-max rule)
        obs[-2] = 1.0 / S
        obs[-1] = obs[-1, 0:1]
    return np.log(obs + np.finfo(np.float32).tiny).astype(np.float32)


def _jax_padded(log_obs, P):
    N, T, S = log_obs.shape
    out = np.full((N, T, P), NEG_PAD, np.float32)
    out[:, :, :S] = log_obs
    return out


@pytest.mark.parametrize("n_bins,d_max,P", [(360, 14, 384), (721, 40, 768)])
def test_plain_k1_k2_bitwise_equal_pallas_and_oracle(rng, n_bins, d_max, P):
    A, pi, _ = _shaped(TP, _tracks(rng, n_bins), n_bins, d_max)
    S = n_bins + 1
    log_B, log_pi = prepare_log_params(A, pi)
    N_j, T = 8, 64
    lens = np.full(N_j, T, np.int32)
    lens[1], lens[2], lens[4] = 40, 1, 33
    log_obs = _log_obs(rng, N_j, T, S)
    bj = JB.extract_banded_structure(A, P)
    _, log_pi_p = prepare_log_params(A, pi, pad_to=P)
    t1_j, t1m1_j = JB.viterbi_forward_pallas_banded_batch(
        bj, jnp.asarray(log_pi_p), jnp.asarray(_jax_padded(log_obs, P)), lens,
        block_frames=32, interpret=True,
    )
    last = jnp.argmax(t1_j[:, :S], axis=1).astype(jnp.int32)
    st_j = np.asarray(JB.viterbi_backtrace_pallas_banded_batch(
        bj, t1m1_j, last, lens, block_frames=32, interpret=True,
    ))
    t1_j, t1m1_j = np.asarray(t1_j), np.asarray(t1m1_j)

    # the port takes N = 7 (not a multiple of 8): tracks 0..6
    N = 7
    bt = TB.extract_banded_structure(A)
    launches = (TB.banded_forward.launches, TB.banded_backtrace.launches)
    t1_t, t1m1_t = TB.banded_forward(bt, log_pi, torch.from_numpy(log_obs[:N]), lens[:N])
    np.testing.assert_array_equal(t1_t.numpy(), t1_j[:N, :S])
    for n in range(N):
        np.testing.assert_array_equal(t1m1_t[n, : lens[n]].numpy(), t1m1_j[n, : lens[n], :S])
    last_t = torch.argmax(t1_t, dim=1).to(torch.int32)
    st_t = TB.banded_backtrace(bt, t1m1_t, last_t, lens[:N]).numpy()
    for n in range(N):
        np.testing.assert_array_equal(st_t[n, : lens[n]], st_j[n, : lens[n]])
        oracle = viterbi_oracle_log(log_B, log_pi, log_obs[n, : lens[n]])
        np.testing.assert_array_equal(st_t[n, : lens[n]], oracle)
    # CPU tensors take the plain versions: no kernel was launched
    assert (TB.banded_forward.launches, TB.banded_backtrace.launches) == launches


def test_wrappers_reject_bad_lengths(rng):
    A, pi, _ = _shaped(TP, _tracks(rng, 60), 60, 6)
    bs = TB.extract_banded_structure(A)
    log_obs = torch.from_numpy(_log_obs(rng, 2, 8, 61, tie_tracks=False))
    for bad in ([0, 8], [8, 9], [8]):
        with pytest.raises(ValueError):
            TB.banded_forward(bs, prepare_log_params(A, pi)[1], log_obs, bad)
