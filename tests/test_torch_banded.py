"""The port's banded path (hmm/viterbi_banded.py of viterbi_spl_tpu_torch)
against the JAX package: shaped matrices, the extracted structure, and the
plain versions of K1/K2 against the Pallas kernels in interpret mode and
the NumPy oracle. The CUDA kernels against their plain versions:
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.hmm import viterbi_banded as JB
from viterbi_spl_tpu.hmm.viterbi import NEG_PAD
from viterbi_spl_tpu_torch.hmm import fixtures as FX
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


@pytest.mark.parametrize("route", [None, "pass", "chain"])
def test_backtrace_routes_give_the_plain_states_on_the_cpu(rng, route):
    """banded_backtrace takes the routes "pass" and "chain" (None: the
    rule's); a CPU tensor takes the plain version by any of them, and an
    unknown route raises."""
    A, pi, _ = _shaped(TP, _tracks(rng, 60), 60, 6)
    bs = TB.extract_banded_structure(A)
    lens = np.array([16, 1, 9], np.int32)
    log_obs = torch.from_numpy(_log_obs(rng, 3, 16, 61))
    t1, t1m1 = TB.banded_forward(bs, prepare_log_params(A, pi)[1], log_obs, lens)
    last = torch.argmax(t1, dim=1).to(torch.int32)
    want = TB.banded_backtrace_plain(bs, t1m1, last, lens)
    assert torch.equal(TB.banded_backtrace(bs, t1m1, last, lens, route=route), want)
    with pytest.raises(ValueError):
        TB.banded_backtrace(bs, t1m1, last, lens, route="scan")


@pytest.mark.parametrize("n_bins,d_max,N,T,voiced,route", [
    (360, 14, 8, 8000, 1.0, "pass"),      # the decode CLI's batch
    (360, 14, 8, 8000, 0.0, "pass"),
    (360, 14, 64, 160, 0.5, "pass"),      # a streaming pool's push
    (360, 14, 128, 32768, 1.0, "pass"),   # bench.py's headline: voiced paths
    (360, 14, 128, 8192, 0.0, "chain"),   # its serving shape: unvoiced paths
    (360, 14, 256, 32768, 1.0, "chain"),  # the pass's scratch would exceed 4 GiB
    (721, 40, 64, 4096, 1.0, "chain"),    # jdc 722
    (721, 40, 16, 4096, 0.0, "pass"),
])
def test_k2_route_at_the_benchmark_shapes(rng, n_bins, d_max, N, T, voiced, route):
    """k2_route picks K2's faster route by the measured costs, reading the
    last states' voiced share only where the choice depends on it."""
    A, _, _ = _shaped(TP, _tracks(rng, n_bins), n_bins, d_max)
    bs = TB.extract_banded_structure(A)
    last = torch.full((N,), n_bins, dtype=torch.int32)
    last[: round(voiced * N)] = n_bins // 2
    assert TB.k2_route(bs, N, T, last) == route


def _chase(bp, last, lengths):
    """s_{t-1} = bp[n, t, s_t] from last[n] at frame lengths[n] - 1."""
    states = np.zeros(bp.shape[:2], np.int64)
    for n, T in enumerate(lengths):
        s = int(last[n])
        states[n, T - 1] = s
        for t in range(T - 1, 0, -1):
            s = int(bp[n, t, s])
            states[n, t - 1] = s
    return states


@pytest.mark.parametrize("n_bins,d_max,P", [(360, 14, 384), (721, 40, 768)])
def test_backpointer_pass_then_chase_on_ties_matches_plain_and_pallas(
        rng, n_bins, d_max, P):
    """K2's design in its plain version: every backpointer
    (banded_backpointers_plain), then a chase over them, gives
    banded_backtrace_plain's states, the tie fixture's path and
    viterbi_backtrace_pallas_banded_batch's (interpreted) below each length,
    on the tie fixture (equal maxima at every step: in band, in and out of
    band either way round, at the unvoiced source)."""
    A, _, _ = _shaped(TP, _tracks(rng, n_bins), n_bins, d_max)
    S = n_bins + 1
    bt = TB.extract_banded_structure(A)
    lens = np.array([64, 1, 2, 40, 64, 33, 63, 17], np.int32)
    t1m1, last, path = FX.tie_fixture(bt, rng, lens, 64)
    bp = TB.banded_backpointers_plain(bt, torch.from_numpy(t1m1), lens)
    assert bp.dtype == torch.int32 and bp.shape == (len(lens), 64, S)
    got = _chase(bp.numpy(), last, lens)
    want = TB.banded_backtrace_plain(bt, torch.from_numpy(t1m1), last, lens).numpy()
    t1m1_j = np.full((len(lens), 64, P), NEG_PAD, np.float32)
    t1m1_j[:, :, :S] = t1m1
    st_j = np.asarray(JB.viterbi_backtrace_pallas_banded_batch(
        JB.extract_banded_structure(A, P), jnp.asarray(t1m1_j), last, lens,
        block_frames=32, interpret=True,
    ))
    for n, L in enumerate(lens):
        np.testing.assert_array_equal(got[n, :L], path[n, :L])
        np.testing.assert_array_equal(want[n, :L], path[n, :L])
        np.testing.assert_array_equal(st_j[n, :L], path[n, :L])


@pytest.mark.parametrize("N,n_bins,d_max,cluster", [
    (128, 360, 14, 0),   # bench.py's headline and its 361 serving shape
    (8, 360, 14, 0),     # the decode CLI's batch
    (64, 360, 14, 0),    # a streaming pool's push
    (64, 721, 40, 2),    # jdc 722 (timing and serving shapes)
    (16, 721, 40, 8),    # chip_smoke's equality phase at 722 states
    (17, 721, 40, 4),
    (34, 721, 40, 2),
    (128, 721, 40, 2),   # more tracks than one block an SM: the smallest cluster
    (8, 360, 20, 8),     # a band too wide for one block's registers at 361
    (8, 360, 50, 0),     # a band too wide for any cluster's registers
])
def test_k1_cluster_at_the_benchmark_shapes(N, n_bins, d_max, cluster):
    """k1_cluster keeps one block per track where its band column fits its
    registers, and otherwise takes the cluster kernel at the largest
    cluster that keeps one block an SM (132 SMs)."""
    assert TB.k1_cluster(N, n_bins + 1, d_max) == cluster


@pytest.mark.parametrize("S,d_max,C,fits", [
    (722, 40, 1, False),  # 736 threads in one block
    (722, 40, 2, True),
    (361, 14, 9, False),  # more than 8 blocks
    (61, 20, 4, False),   # blocks of fewer targets than d_max
    (361, 42, 2, False),  # 85 band offsets
    (501, 41, 2, True),   # 83
    (57, 8, 8, True),     # the last block holds the unvoiced state alone
    (49, 6, 8, False),    # the last block would hold no target (7 blocks of 7)
])
def test_k1_cluster_fits_the_kernel_limits(S, d_max, C, fits):
    """k1_cluster_fits states the cluster kernel's limits, which its C entry
    enforces (the GPU tests hold the entry to them)."""
    assert TB.k1_cluster_fits(S, d_max, C) is fits


@pytest.mark.parametrize("cluster", [None, 0, 2])
def test_banded_forward_cluster_on_the_cpu(rng, cluster):
    """banded_forward's `cluster` changes only the card's layout: a CPU
    tensor takes the plain version by any."""
    A, pi, _ = _shaped(TP, _tracks(rng, 60), 60, 6)
    bs = TB.extract_banded_structure(A)
    lens = np.array([16, 1, 9], np.int32)
    log_obs = torch.from_numpy(_log_obs(rng, 3, 16, 61))
    log_pi = prepare_log_params(A, pi)[1]
    want = TB.banded_forward_plain(bs, torch.from_numpy(log_pi), log_obs, lens)
    got = TB.banded_forward(bs, log_pi, log_obs, lens, cluster=cluster)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
