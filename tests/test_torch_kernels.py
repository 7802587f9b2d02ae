"""The CUDA kernels against their plain PyTorch versions on the card: K1-K4
with exact equality of t1_last, of t1m1 up to each track's length, and of
the decoded states, with ragged lengths and N not a multiple of 8; K1 by
every layout (one block a track, clusters of 1-8 blocks) and K3 by both
routes (K7's kernel at 1-4 tracks a cluster, the cluster kernel), also
over more tracks than the card holds clusters at once; K2 also
on a tie fixture whose chase meets equal maxima at every step; K4 by
its segments (the rule's, one chain, short ones whose seams re-chase) on
ragged lengths and ties at every step, also over more tracks than one
grid dimension holds; K5/K6 under the observation contract
(hmm/obs_fused.py::obs_contract), also on frame counts that are not a
multiple of the tile, widths of 2-1024 bins, window half-widths of 1 and
n_bins - 1, unaligned inputs and at every layout; K9
bit-equal to K5/K6 -> K1, at its own producer and ring layout and at
others; K7/K8 (the window kernels) exactly, with reset
rows, at 8- and 16-block cluster sizes and over more windows than one wave
holds, and the time-block decode's launches over a mesh of blocks on one
card; the decode APIs' repeat taking the prepared HMM's card tables, with
one upload (the lengths) on each route.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so that it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch import tracing
from viterbi_spl_tpu_torch.hmm import fixtures as FX
from viterbi_spl_tpu_torch.hmm import obs_fused as OF
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
@pytest.mark.parametrize("n_bins,d_max", [(360, 14), (721, 40), (320, 6), (320, 12)])
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


K2_LENGTHS = np.array([160, 1, 2, 97, 160, 33, 2, 159, 64, 17, 120], np.int32)


def _k1_against_plain(cuda, rng, n_bins, d_max, cluster, lengths, T):
    A, pi = _shaped(rng, n_bins, d_max)
    _, log_pi = prepare_log_params(A, pi)
    bs = TB.extract_banded_structure(A)
    assert bs.d_max == d_max
    log_obs = _log_obs(rng, len(lengths), T, n_bins + 1)
    launches = TB.banded_forward.launches
    t1_p, t1m1_p = TB.banded_forward_plain(bs, torch.from_numpy(log_pi), log_obs, lengths)
    t1_k, t1m1_k = TB.banded_forward(bs, log_pi, log_obs.to(cuda), lengths, cluster=cluster)
    assert TB.banded_forward.launches == launches + 1
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t1_k.cpu().numpy(), t1_p.numpy())
    for n, L in enumerate(lengths):
        np.testing.assert_array_equal(t1m1_k[n, :L].cpu().numpy(), t1m1_p[n, :L].numpy())


# (n_bins, d_max, cluster sizes): 361, 722 and dcnet's 321 states (d_max 6,
# and 12, the band of the shaped matrices its artifacts give) at every
# layout the cluster kernel takes there; the register band's two widths on both sides
# of their boundary (2 d_max + 1 = 31 | 33, 83); a last block of fewer
# than d_max targets (29 states over 2 blocks at d_max 15, 49 over 4 at
# 13), and one that owns only the unvoiced state (57 over 8 at 8)
K1_LAYOUTS = [(360, 14, (0, 1, 2, 4, 8)), (721, 40, (0, 2, 4, 8)), (320, 6, (0, 1, 2, 4, 8)),
              (320, 12, (0, 1, 2, 4, 8)), (200, 15, (1, 2, 8)),
              (200, 16, (1, 2, 8)), (500, 41, (2, 4)), (28, 15, (1, 2)), (48, 13, (4,)),
              (56, 8, (8,))]


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,d_max,clusters", K1_LAYOUTS)
def test_cuda_k1_every_layout_matches_plain(cuda, rng, n_bins, d_max, clusters):
    """K1 by one block per track (cluster 0) and by clusters of 1-8 blocks
    per track, on ragged lengths (1 and 2 among them) and tie-heavy tracks:
    t1_last and t1m1 up to each length equal the plain version's, bit for
    bit."""
    lengths = np.array([96, 50, 1, 2, 77, 96, 13], np.int32)
    for cluster in clusters:
        _k1_against_plain(cuda, rng, n_bins, d_max, cluster, lengths, 96)


# track counts on both sides of each of k1_cluster's boundaries at 722
# states and 132 SMs (8 | 4 | 2 blocks a track at 16 | 17 and 33 | 34
# tracks; the smallest cluster beyond 66)
K1_RULE_TRACKS = (2, 16, 17, 33, 34, 66, 67)


@pytest.mark.gpu
def test_cuda_k1_rule_layouts_match_plain(cuda, rng):
    """K1 by the layout k1_cluster picks, at the track counts on both sides
    of each of its boundaries (361 and 722 states), on ragged lengths."""
    for n_bins, d_max in ((360, 14), (721, 40)):
        for N in K1_RULE_TRACKS:
            lengths = np.resize(np.array([40, 1, 2, 39, 17], np.int32), N)
            _k1_against_plain(cuda, rng, n_bins, d_max, None, lengths, 40)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,d_max,cluster", [(721, 40, 1), (360, 14, 9), (360, 50, 2),
                                                  (60, 20, 4), (360, 42, 2)])
def test_cuda_k1_refuses_layouts_it_cannot_run(cuda, rng, n_bins, d_max, cluster):
    """The cluster kernel raises rather than runs a layout it cannot hold:
    more than 384 threads a block (722 states in one block), more than 8
    blocks, a band wider than its registers (2 d_max + 1 > 84), blocks of
    fewer targets than d_max."""
    A, pi = _shaped(rng, n_bins, min(d_max, n_bins - 2))
    bs = TB.extract_banded_structure(A)
    log_obs = _log_obs(rng, 2, 8, n_bins + 1).to(cuda)
    if bs.d_max != d_max:
        pytest.skip("the shaped matrix did not reach this d_max")
    with pytest.raises(RuntimeError, match="K1"):
        TB.banded_forward(bs, prepare_log_params(A, pi)[1], log_obs, [8, 3], cluster=cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,d_max", [(360, 14), (721, 40), (300, 50), (320, 6), (320, 12)])
@pytest.mark.parametrize("fixture", ["forward", "ties"])
@pytest.mark.parametrize("route", ["pass", "chain"])
def test_cuda_k2_ragged_and_ties_match_plain(cuda, rng, n_bins, d_max, fixture, route):
    """K2 against its plain version over 11 ragged tracks (lengths 1 and 2
    among them), by both routes (the backpointer pass then the chase, and a
    chain per track): on K1's t1m1 of random and tie-heavy observations, and
    on the tie fixture, where every step of each chase meets two equal
    maxima (in band, in and out of band either way round, at the unvoiced
    source) and the states must be the fixture's path. The pass keeps 32
    band values a thread in registers at d_max 14, 96 at d_max 40, and reads
    them through L1 at d_max 50."""
    A, pi = _shaped(rng, n_bins, d_max)
    _, log_pi = prepare_log_params(A, pi)
    bs = TB.extract_banded_structure(A)
    N, T = len(K2_LENGTHS), 160
    if fixture == "ties":
        t1m1, last, path = FX.tie_fixture(bs, rng, K2_LENGTHS, T)
        t1m1 = torch.from_numpy(t1m1)
    else:
        log_obs = _log_obs(rng, N, T, n_bins + 1)
        t1, t1m1 = TB.banded_forward_plain(bs, torch.from_numpy(log_pi), log_obs, K2_LENGTHS)
        last, path = torch.argmax(t1, dim=1).to(torch.int32).numpy(), None
    launches = TB.banded_backtrace.launches
    st_k = TB.banded_backtrace(bs, t1m1.to(cuda), torch.from_numpy(last).to(cuda), K2_LENGTHS,
                               route=route)
    torch.cuda.synchronize()
    assert TB.banded_backtrace.launches == launches + 1
    st_p = TB.banded_backtrace_plain(bs, t1m1, last, K2_LENGTHS)
    for n, L in enumerate(K2_LENGTHS):
        np.testing.assert_array_equal(st_k[n, :L].cpu().numpy(), st_p[n, :L].numpy())
        if path is not None:
            np.testing.assert_array_equal(st_p[n, :L].numpy(), path[n, :L])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pass", "chain"])
def test_cuda_k2_more_tracks_than_a_grid_dimension(cuda, rng, route):
    """K2 over 65,537 short ragged tracks by both routes (the pass puts
    tracks on grid.z, at most 65,535 a launch; the chain on grid.x) equals
    its plain version."""
    A, pi = _shaped(rng, 60, 6)
    _, log_pi = prepare_log_params(A, pi)
    bs = TB.extract_banded_structure(A)
    N, T = 65537, 5
    lengths = rng.integers(1, T + 1, N).astype(np.int32)
    log_obs = torch.from_numpy(rng.uniform(-20.0, 0.0, (N, T, 61)).astype(np.float32)).to(cuda)
    t1, t1m1 = TB.banded_forward(bs, log_pi, log_obs, lengths)
    last = torch.argmax(t1, dim=1).to(torch.int32)
    st_k = TB.banded_backtrace(bs, t1m1, last, lengths, route=route)
    st_p = TB.banded_backtrace_plain(bs, t1m1, last, lengths)
    mask = torch.arange(T, device=cuda)[None, :] < torch.from_numpy(lengths).to(cuda)[:, None]
    assert torch.equal(torch.where(mask, st_k, 0), torch.where(mask, st_p, 0))


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


def _dense_case(rng, S):
    if S == 722:
        return TP.imm_transition_matrix(20, 721), np.full(S, 1.0 / S)
    A = rng.random((S, S)).astype(np.float32) ** 4
    A /= A.sum(1, keepdims=True)
    return A, np.full(S, 1.0 / S)


def _dense_ties(rng, S, N, T):
    """(A, t1m1): a dense matrix whose rows are permutations of one row (its
    log_B takes three values, each equal across rows) and integer t1m1
    rows, so every step of every chase meets equal maxima."""
    base = np.repeat(np.float32([1, 2, 3]), -(-S // 3))[:S]
    base = (base / base.sum()).astype(np.float32)
    A = np.stack([rng.permutation(base) for _ in range(S)])
    return A, rng.integers(0, 4, (N, T, S)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [361, 722])
@pytest.mark.parametrize("data", ["forward", "ties"])
@pytest.mark.parametrize("segment,warmup", [(None, TD.K4_WARMUP), (10**6, 0), (7, 0), (16, 3),
                                            (5, 40)])
def test_cuda_k4_segments_match_plain(cuda, rng, S, data, segment, warmup):
    """K4 by its rule's segments, as one chain (a segment longer than the
    tracks), in short segments with no or a short warm-up (the seams
    re-chase), and with a warm-up longer than the segment; on ragged
    lengths (1 and 2 among them) of K3's t1m1 and of a t1m1 with first-max
    ties at every step: the states equal the plain version's below each
    length, in one counted launch."""
    lengths = np.array([96, 50, 1, 2, 77, 96, 13, 64], np.int32)
    N, T = len(lengths), 96
    if data == "forward":
        A, pi = _dense_case(rng, S)
        log_B, log_pi = prepare_log_params(A, pi)
        t1, t1m1 = TD.dense_forward(log_B, log_pi, _log_obs(rng, N, T, S).to(cuda), lengths)
        last = torch.argmax(t1, dim=1).to(torch.int32)
    else:
        A, t1m1 = _dense_ties(rng, S, N, T)
        log_B, _ = prepare_log_params(A, np.full(S, 1.0 / S))
        t1m1 = torch.from_numpy(t1m1).to(cuda)
        last = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(cuda)
    fixups = torch.zeros(N, dtype=torch.int32, device=cuda)
    launches = TD.dense_backtrace.launches
    st_k = TD.dense_backtrace(log_B, t1m1, last, lengths, segment=segment, warmup=warmup,
                              fixups=fixups)
    assert TD.dense_backtrace.launches == launches + 1
    st_p = TD.dense_backtrace_plain(torch.from_numpy(log_B), t1m1.cpu(), last.cpu(), lengths)
    torch.cuda.synchronize()
    for n, L in enumerate(lengths):
        np.testing.assert_array_equal(st_k[n, :L].cpu().numpy(), st_p[n, :L].numpy())
    if data == "ties" and warmup == 0 and segment < T:
        assert int(fixups.sum()) > 0  # the seams re-chased


@pytest.mark.gpu
@pytest.mark.parametrize("segment,warmup", [(None, TD.K4_WARMUP), (2, 0)])
def test_cuda_k4_more_tracks_than_a_grid_dimension(cuda, rng, segment, warmup):
    """K4 over 65,537 short ragged tracks with ties at every step, as one
    chain a track (the rule, with more tracks than warps resident) and in
    segments of 2 frames (196,611 segment warps, then 65,537 seam warps):
    equal to its plain version."""
    S, N, T = 40, 65537, 5
    A, t1m1 = _dense_ties(rng, S, N, T)
    log_B, _ = prepare_log_params(A, np.full(S, 1.0 / S))
    lengths = rng.integers(1, T + 1, N).astype(np.int32)
    t1m1 = torch.from_numpy(t1m1).to(cuda)
    last = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(cuda)
    st_k = TD.dense_backtrace(log_B, t1m1, last, lengths, segment=segment, warmup=warmup)
    st_p = TD.dense_backtrace_plain(torch.from_numpy(log_B).to(cuda), t1m1, last, lengths)
    mask = torch.arange(T, device=cuda)[None, :] < torch.from_numpy(lengths).to(cuda)[:, None]
    assert torch.equal(torch.where(mask, st_k, 0), torch.where(mask, st_p, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [361, 722, 769])
def test_cuda_k3_routes_match_plain(cuda, rng, S):
    """K3 by both its routes (K7's kernel with reset rows 0, at 1-4 tracks a
    cluster, where S <= 768; the cluster kernel at any S) on ragged lengths
    and tie-heavy tracks, bit-equal to dense_forward_plain; above 768
    states k3_route takes the cluster kernel and the window route raises."""
    A, pi = _dense_case(rng, S)
    log_B, log_pi = prepare_log_params(A, pi)
    lengths = np.array([96, 50, 1, 2, 77, 96, 13], np.int32)
    log_obs = _log_obs(rng, len(lengths), 96, S)
    t1_p, t1m1_p = TD.dense_forward_plain(torch.from_numpy(log_B), torch.from_numpy(log_pi),
                                          log_obs, lengths)
    runs = [("cluster", None)]
    if S <= TD.K7_MAX_STATES:
        runs += [("window", g) for g in (1, 2, 3, 4)] + [(None, None)]
    else:
        assert TD.k3_route(S) == "cluster"
        with pytest.raises(ValueError, match="K3"):
            TD.dense_forward(log_B, log_pi, log_obs.to(cuda), lengths, route="window")
    for route, tracks in runs:
        t1_k, t1m1_k = TD.dense_forward(log_B, log_pi, log_obs.to(cuda), lengths, route=route,
                                        tracks=tracks)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(t1_k.cpu().numpy(), t1_p.numpy())
        for n, L in enumerate(lengths):
            np.testing.assert_array_equal(t1m1_k[n, :L].cpu().numpy(), t1m1_p[n, :L].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("S", [361, 722])
def test_cuda_k3_more_tracks_than_clusters_resident(cuda, rng, S):
    """K3's window route over more tracks than the card holds clusters at
    once (three times as many, one track a cluster, and by the rule),
    ragged: equal to the plain version."""
    A, pi = _dense_case(rng, S)
    log_B, log_pi = prepare_log_params(A, pi)
    N = 3 * TD.window_max_clusters(S) + 1
    lengths = rng.integers(1, 25, N).astype(np.int32)
    log_obs = _log_obs(rng, N, 24, S)
    t1_p, t1m1_p = TD.dense_forward_plain(torch.from_numpy(log_B), torch.from_numpy(log_pi),
                                          log_obs, lengths)
    for tracks in (1, None):
        t1_k, t1m1_k = TD.dense_forward(log_B, log_pi, log_obs.to(cuda), lengths,
                                        route="window", tracks=tracks)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(t1_k.cpu().numpy(), t1_p.numpy())
        for n, L in enumerate(lengths):
            np.testing.assert_array_equal(t1m1_k[n, :L].cpu().numpy(), t1m1_p[n, :L].numpy())


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


METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")


def _shaped(rng, n_bins, d_max):
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 4000)), 0, n_bins - 1)]
    stats = TP.count_statistics(walk, n_bins)
    A = TP.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]), n_bins, d_max, 2
    )
    return A, TP.shape_init_probs(stats.p_steady, p_th=1e-4)


def _obs_cfg(rng, method, n_bins, spw):
    pri = rng.random(n_bins + 1).astype(np.float32) + 0.1
    return dict(method=method, spw=spw, threshold_logit=0.3, init_probs=pri / pri.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,spw", [(360, 5), (721, 16), (721, 20), (320, 5)])
@pytest.mark.parametrize("method", METHODS)
def test_cuda_k5_k6_match_plain(cuda, rng, n_bins, spw, method):
    """K5/K6 against their plain versions on the card: lanes at log TINY
    bit-equal, rtol 2e-4 (atol 1e-6) above -80, at most log 2 in the floor
    region, the unvoiced lane within rtol 1e-6 (plus (p + 1) 2^-24 for the
    softmax models: obs_contract's sum-order term)."""
    lg = torch.from_numpy(OF.contract_logits(rng, len(LENGTHS), 64, n_bins)).to(cuda)
    obs = _obs_cfg(rng, method, n_bins, spw)
    wrapper = OF.shaun_log_obs if method == "shaun" else OF.softmax_log_obs
    launches = wrapper.launches
    got = OF.log_obs(lg, obs)
    assert wrapper.launches == launches + 1
    res = OF.obs_contract(got.cpu().numpy(), OF.log_obs_plain(lg, obs).cpu().numpy(),
                          softmax=method != "shaun")
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,spw", [(2, 1), (361, 1), (361, 360), (721, 1), (721, 720),
                                        (1024, 1), (1024, 1023)])
@pytest.mark.parametrize("method", ["shaun", "softmax-scaled"])
def test_cuda_k5_k6_tiles_and_alignment_match_plain(cuda, rng, n_bins, spw, method):
    """K5/K6 on 3 x 37 frames (not a multiple of the 8-frame tile) at
    widths of 2 to 1024 bins and window half-widths of 1 and n_bins - 1,
    read from an aligned input and from a copy whose start is 4 bytes past
    a 16-byte boundary (with odd n_bins every tile's head and tail are
    unaligned): the two bit-equal, and under the observation contract
    against the plain version."""
    N, T = 3, 37
    aligned = torch.from_numpy(OF.contract_logits(rng, N, T, n_bins)).to(cuda)
    buf = torch.empty(N * T * n_bins + 4, dtype=torch.float32, device=cuda)
    shifted = buf[1:1 + N * T * n_bins].view(N, T, n_bins)
    shifted.copy_(aligned)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    obs = _obs_cfg(rng, method, n_bins, spw)
    got = OF.log_obs(aligned, obs)
    assert torch.equal(OF.log_obs(shifted, obs), got)
    res = OF.obs_contract(got.cpu().numpy(), OF.log_obs_plain(aligned, obs).cpu().numpy(),
                          softmax=method != "shaun")
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(1, 1, 1), (2, 3, 2), (1, 15, 2), (2, 7, 6), (4, 8, 2)])
@pytest.mark.parametrize("method", ["shaun", "softmax-scaled"])
def test_cuda_k5_k6_any_layout_bit_equal(cuda, rng, layout, method):
    """K5/K6 at layouts (blocks an SM, consumer warps, stages) other than
    obs_layout's give the same bits, at 722 states (spw 16) on 5 x 41
    frames: one stage, consumers that stride over two tiles, more blocks
    than an SM holds."""
    n_bins = 721
    lg = torch.from_numpy(OF.contract_logits(rng, 5, 41, n_bins)).to(cuda)
    _, spw, params, log_prior = OF.obs_params(_obs_cfg(rng, method, n_bins, 16), n_bins)
    prior = None if method == "shaun" else log_prior
    want = OF._launch(lg, spw, params, prior)
    assert torch.equal(OF._launch(lg, spw, params, prior, layout=layout), want)


# K9's tracks: T=96 a multiple of its rings (32 frames at 361 states, 16 at
# 722), T=101 not; lengths shorter than either ring among them
K9_LENGTHS = {96: LENGTHS, 101: np.array([101, 1, 2, 15, 31, 33, 100], np.int32)}


def _k9_against_k5_k6_k1(cuda, rng, n_bins, d_max, spw, method, T):
    A, pi = _shaped(rng, n_bins, d_max)
    _, log_pi = prepare_log_params(A, pi)
    bs = TB.extract_banded_structure(A)
    lengths = K9_LENGTHS[T]
    lg = torch.from_numpy(OF.contract_logits(rng, len(lengths), T, n_bins)).to(cuda)
    obs = _obs_cfg(rng, method, n_bins, spw)
    launches = TB.banded_forward_obs.launches
    t1_9, t1m1_9 = TB.banded_forward_obs(bs, log_pi, lg, lengths, obs)
    assert TB.banded_forward_obs.launches == launches + 1
    t1_1, t1m1_1 = TB.banded_forward(bs, log_pi, OF.log_obs(lg, obs), lengths)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t1_9.cpu().numpy(), t1_1.cpu().numpy())
    for n, L in enumerate(lengths):
        np.testing.assert_array_equal(t1m1_9[n, :L].cpu().numpy(), t1m1_1[n, :L].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("T", [96, 101])
@pytest.mark.parametrize("n_bins,d_max,spw", [(360, 14, 5), (721, 40, 16)])
@pytest.mark.parametrize("method", METHODS)
def test_cuda_k9_bit_equal_k5_k6_then_k1(cuda, rng, n_bins, d_max, spw, method, T):
    """K9 (the observations inside the forward) bit-equal to K5/K6 -> K1:
    t1_last, and t1m1 up to each track's length, with ragged lengths."""
    _k9_against_k5_k6_k1(cuda, rng, n_bins, d_max, spw, method, T)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(1, 2), (2, 3), (7, 7), (3, 40)])
@pytest.mark.parametrize("n_bins,d_max,spw,method", [(360, 14, 5, "shaun"),
                                                     (721, 40, 16, "softmax-scaled")])
def test_cuda_k9_any_layout_bit_equal(cuda, rng, monkeypatch, layout, n_bins, d_max, spw,
                                      method):
    """K9 at producer and ring layouts other than its rule's (one producer
    and a two-frame ring, a ring as long as the producers' stride, a ring
    longer than most tracks): still bit-equal to K5/K6 -> K1."""
    monkeypatch.setattr(TB, "k9_layout", lambda S, model: layout)
    _k9_against_k5_k6_k1(cuda, rng, n_bins, d_max, spw, method, 101)


@pytest.mark.gpu
def test_cuda_k9_refuses_a_ring_shorter_than_its_producers(cuda, rng, monkeypatch):
    """A ring of fewer frames than producers would let a producer's parity
    wait on a slot alias an older phase: the launch is refused."""
    A, pi = _shaped(rng, 60, 6)
    bs = TB.extract_banded_structure(A)
    lg = torch.from_numpy(OF.contract_logits(rng, 2, 16, 60)).to(cuda)
    monkeypatch.setattr(TB, "k9_layout", lambda S, model: (7, 5))
    with pytest.raises(RuntimeError, match="K9"):
        TB.banded_forward_obs(bs, prepare_log_params(A, pi)[1], lg, [16, 9],
                              _obs_cfg(rng, "shaun", 60, 5))


@pytest.mark.gpu
def test_fused_decode_api_runs_the_kernels(cuda, rng):
    """viterbi_decode_batch_fused_obs on the card launches K9 and K2 for a
    shaped matrix, K5 then K3/K4 for a dense one (K6 for softmax); paths
    equal the oracle on the card's own fused log observations."""
    n_bins = 120
    shaped, pi = _shaped(rng, n_bins, 8)
    dense = TP.imm_transition_matrix(4, n_bins)
    lens = np.array([70, 1, 33], np.int32)
    lg = rng.normal(-2, 1, (3, 70, n_bins)).astype(np.float32)
    lg[:, np.arange(70), 60 + np.arange(70) // 7] += 6.0
    lg = torch.from_numpy(lg).to(cuda)
    for A, method, kernels in ((shaped, "shaun", ("K9", "K2")),
                               (dense, "shaun", ("K5", "K3", "K4")),
                               (dense, "softmax-scaled", ("K6", "K3", "K4"))):
        obs = _obs_cfg(rng, method, n_bins, 5)
        before = {k: TD.KERNEL_WRAPPERS[k].launches for k in TD.KERNEL_WRAPPERS}
        got = TD.viterbi_decode_batch_fused_obs(
            transition_matrix=A, prob_init=pi, logits=lg, lengths=lens, obs=obs
        ).cpu().numpy()
        after = {k: TD.KERNEL_WRAPPERS[k].launches for k in TD.KERNEL_WRAPPERS}
        assert {k for k in after if after[k] != before[k]} == set(kernels)
        log_B, log_pi = prepare_log_params(A, pi)
        log_obs = OF.log_obs(lg, obs).cpu().numpy()
        for n, L in enumerate(lens):
            np.testing.assert_array_equal(
                got[n, :L], viterbi_oracle_log(log_B, log_pi, log_obs[n, :L])
            )


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["K9", "K1", "K3"])
def test_decode_api_uploads_only_the_lengths(cuda, rng, route):
    """A decode API's repeat on the card takes the prepared HMM's card tables:
    tables_reused 1 and no build, one blocking copy (the lengths, before the
    forward), none after it, the kernels of its route launched once each,
    and paths equal the oracle's on the card's own log observations."""
    n_bins = 120
    A, pi = _shaped(rng, n_bins, 8) if route != "K3" else (
        TP.imm_transition_matrix(4, n_bins), np.full(n_bins + 1, 1.0 / (n_bins + 1)))
    lens = np.array([70, 1, 33], np.int32)
    lg = rng.normal(-2, 1, (3, 70, n_bins)).astype(np.float32)
    lg[:, np.arange(70), 60 + np.arange(70) // 7] += 6.0
    lg = torch.from_numpy(lg).to(cuda)
    obs = _obs_cfg(rng, "shaun", n_bins, 5)
    log_obs = OF.log_obs(lg, obs)
    if route == "K9":
        def decode():
            return TD.viterbi_decode_batch_fused_obs(transition_matrix=A, prob_init=pi, logits=lg,
                                                     lengths=lens, obs=obs)
    else:
        def decode():
            return TD.viterbi_decode_batch_logobs(transition_matrix=A, prob_init=pi,
                                                  log_obs=log_obs, lengths=lens)
    first = decode().cpu().numpy()
    kernels = {"K9": ("K9", "K2"), "K1": ("K1", "K2"), "K3": ("K3", "K4")}[route]
    tracing.clear()
    with tracing.enabled():
        again, made = TD.counted_launches(decode)
        again = again.cpu().numpy()
    spans = tracing.spans()
    tracing.clear()
    assert made == {k: 1 for k in kernels}
    assert sum(s.counts.get("tables_built", 0) for s in spans) == 0
    assert sum(s.counts.get("tables_reused", 0) for s in spans) == 1
    decode_span = next(s for s in spans if s.name == "decode")
    forward = next(s for s in spans if s.name == "decode.forward")
    waits = [s for s in spans if s.name == "decode.wait"]
    assert len(waits) == 1 and waits[0].parent == forward.id
    assert waits[0].counts == {"host_waits": 1, "h2d_bytes": 4 * len(lens)}
    assert decode_span.attrs["route"] == ("dense" if route == "K3" else "pass")
    log_B, log_pi = prepare_log_params(A, pi)
    host_obs = log_obs.cpu().numpy()
    for n, L in enumerate(lens):
        want = viterbi_oracle_log(log_B, log_pi, host_obs[n, :L])
        np.testing.assert_array_equal(first[n, :L], want)
        np.testing.assert_array_equal(again[n, :L], want)


RESETS = np.array([0, -1, 16, 0, -1, 5], np.int32)  # K7's reset rows, each < its length


@pytest.mark.gpu
@pytest.mark.parametrize("S", [361, 722])
def test_cuda_k7_k8_match_plain(cuda, rng, S):
    """K7/K8 (the window kernels of the sequence-parallel decode) against
    their plain versions over ragged windows with reset rows 0, -1 and
    mid-window, in one launch each: exact t1_last, t1m1 up to each length
    and states; a window with reset row 0 against the oracle."""
    if S == 722:
        A, pi = TP.imm_transition_matrix(20, 721), np.full(S, 1.0 / S)
    else:
        A, pi = _shaped(rng, 360, 14)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = _log_obs(rng, len(LENGTHS), 96, S)
    lB, lpi = torch.from_numpy(log_B), torch.from_numpy(log_pi)
    resets = np.minimum(RESETS, LENGTHS - 1)
    launches = (TD.window_forward.launches, TD.window_backtrace.launches)
    t1_p, t1m1_p = TD.window_forward_plain(lB, lpi, log_obs, LENGTHS, resets)
    t1_k, t1m1_k = TD.window_forward(log_B, log_pi, log_obs.to(cuda), LENGTHS, resets)
    start = torch.argmax(t1_p, dim=1)
    st_p = TD.window_backtrace_plain(lB, t1m1_p, start, LENGTHS)
    st_k = TD.window_backtrace(log_B, t1m1_k, start.to(cuda), LENGTHS)
    torch.cuda.synchronize()
    assert (TD.window_forward.launches, TD.window_backtrace.launches) == (
        launches[0] + 1, launches[1] + 1)
    _check(t1_k, t1m1_k, st_k, t1_p, t1m1_p, st_p, LENGTHS)
    np.testing.assert_array_equal(
        st_k[0].cpu().numpy(), viterbi_oracle_log(log_B, log_pi, log_obs[0].numpy())
    )


def _window_case(rng, S):
    """(A, pi) for the window kernels at S states: tonet's shaped matrix at
    361, imm's analytic one at 722, else a seeded random dense matrix."""
    if S == 722:
        return TP.imm_transition_matrix(20, 721), np.full(S, 1.0 / S)
    if S == 361:
        return _shaped(rng, 360, 14)
    A = rng.random((S, S)).astype(np.float32) ** 4
    return A / A.sum(1, keepdims=True), np.full(S, 1.0 / S)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [61, 200, 361, 400, 722])
def test_cuda_k7_k8_many_windows_match_plain(cuda, rng, S):
    """K7/K8 over 12 ragged windows in one launch each: more clusters than
    fit in one wave at 722 states (16-block clusters), 8-block clusters up
    to 384 states and fewer blocks where a small S leaves a block without a
    target; lengths 1, 2 and the full window; reset rows 0, -1, 1 and
    mid-window; the tie-heavy windows of _log_obs. Exact t1_last, t1m1 up
    to each length and states; each window with reset row 0 against the
    oracle."""
    A, pi = _window_case(rng, S)
    log_B, log_pi = prepare_log_params(A, pi)
    lengths = np.array([300, 1, 2, 300, 177, 2, 300, 64, 299, 5, 250, 300], np.int32)
    resets = np.minimum(np.array([0, 0, 1, -1, 90, -1, 150, 0, 0, 4, -1, 0], np.int32),
                        lengths - 1)
    log_obs = _log_obs(rng, len(lengths), 300, S)
    lB, lpi = torch.from_numpy(log_B), torch.from_numpy(log_pi)
    t1_p, t1m1_p = TD.window_forward_plain(lB, lpi, log_obs, lengths, resets)
    t1_k, t1m1_k = TD.window_forward(log_B, log_pi, log_obs.to(cuda), lengths, resets)
    start = torch.argmax(t1_p, dim=1)
    st_p = TD.window_backtrace_plain(lB, t1m1_p, start, lengths)
    st_k = TD.window_backtrace(log_B, t1m1_k, start.to(cuda), lengths)
    torch.cuda.synchronize()
    _check(t1_k, t1m1_k, st_k, t1_p, t1m1_p, st_p, lengths)
    for n in np.flatnonzero(resets == 0):
        L = int(lengths[n])
        np.testing.assert_array_equal(
            st_k[n, :L].cpu().numpy(), viterbi_oracle_log(log_B, log_pi, log_obs[n, :L].numpy())
        )


@pytest.mark.gpu
def test_time_blocks_one_launch_per_device(cuda, rng):
    """The time-block decode over a mesh of 4 blocks on one card runs one K7
    and one K8 launch, and gives the CPU mesh's states and seam flags."""
    from viterbi_spl_tpu_torch.dist import make_mesh, viterbi_sharded_time_blocks

    A, pi = _shaped(rng, 60, 6)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = _log_obs(rng, 3, 512, 61)[0]  # a track with no ties (the last two have)
    launches = (TD.window_forward.launches, TD.window_backtrace.launches)
    got = viterbi_sharded_time_blocks(log_B, log_pi, log_obs.to(cuda),
                                      make_mesh(seq=4, devices=[cuda] * 4), halo=32)
    assert (TD.window_forward.launches, TD.window_backtrace.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = viterbi_sharded_time_blocks(log_B, log_pi, log_obs,
                                       make_mesh(seq=4, devices=["cpu"] * 4), halo=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
