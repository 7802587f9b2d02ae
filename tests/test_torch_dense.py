"""The port's dense path (hmm/viterbi_dense.py of viterbi_spl_tpu_torch):
the plain versions of K3/K4 against the JAX package's Pallas kernels in
interpret mode and the NumPy oracle, K4's design on the card (backpointers
then a chase; the chase in segments with exact seams) modelled in NumPy
against the JAX batch backtrace, its and K3's host rules, and the batched
decode API's dispatch. The CUDA kernels against their plain versions:
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
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


@pytest.mark.parametrize("S", [90, 361])
def test_dense_forward_plain_is_the_window_forward_from_reset_row_0(rng, S):
    """K3's contract on the card rests on this: the dense batched forward
    is K7's forward with every reset row 0, bit for bit, on ragged lengths
    (1 and 2 among them) and a tie-heavy track; and dense_forward on a CPU
    tensor gives it by every route."""
    A, pi, _ = random_hmm(rng, S, 8)
    log_B, log_pi = (torch.from_numpy(x) for x in prepare_log_params(A, pi))
    lens = np.array([40, 1, 2, 33, 40, 7], np.int32)
    log_obs = torch.from_numpy(_batch(rng, A, len(lens), 40))
    t1_d, t1m1_d = TD.dense_forward_plain(log_B, log_pi, log_obs, lens)
    t1_w, t1m1_w = TD.window_forward_plain(log_B, log_pi, log_obs, lens,
                                           np.zeros(len(lens), np.int32))
    assert torch.equal(t1_d, t1_w) and torch.equal(t1m1_d, t1m1_w)
    for route in (None, *TD.DENSE_ROUTES):
        t1_r, t1m1_r = TD.dense_forward(log_B, log_pi, log_obs, lens, route=route)
        assert torch.equal(t1_r, t1_d) and torch.equal(t1m1_r, t1m1_d)
    with pytest.raises(ValueError):
        TD.dense_forward(log_B, log_pi, log_obs, lens, route="scan")


@pytest.mark.parametrize("S,route", [(361, "window"), (722, "window"), (768, "window"),
                                     (769, "cluster"), (1024, "cluster")])
def test_k3_route_by_states(S, route):
    """K3 takes K7's kernel up to the 768 states it holds, its cluster
    kernel above."""
    assert TD.k3_route(S) == route


@pytest.mark.parametrize("N,clusters,G", [
    (16, 7, 3),    # imm 722 (16-block clusters: 7 at once on an H100)
    (4, 7, 1),     # the imm DecoderSetup's batch
    (16, 15, 2),   # random 361 (8-block clusters: 15 at once)
    (64, 7, 2),    # a 64-stream dense push at 722 states
    (64, 15, 3),   # and at 361
    (7, 7, 1),     # one wave
    (8, 7, 2),     # one track more than a wave
])
def test_k3_tracks_per_cluster_at_the_benchmark_shapes(N, clusters, G):
    """k3_tracks_per_cluster's choice by the measured cost of G tracks a
    cluster against the waves they save."""
    assert TD.k3_tracks_per_cluster(N, clusters) == G


# ---- K4: the chase in segments (csrc/viterbi_dense.cu) --------------------


def _tie_case(rng, S, N, T):
    """A dense matrix whose rows are permutations of one row, so that log_B
    takes three values, each equal across rows, and integer t1m1 rows: the
    first-max argmax meets equal maxima at every step of every chase."""
    base = np.repeat(np.float32([1, 2, 3]), -(-S // 3))[:S]
    base = (base / base.sum()).astype(np.float32)
    A = np.stack([rng.permutation(base) for _ in range(S)])
    return A, rng.integers(0, 4, (N, T, S)).astype(np.float32)


def _chase(bp, start, lengths):
    """s_{t-1} = bp[n, t, s_t] from start[n] at frame lengths[n] - 1."""
    states = np.zeros(bp.shape[:2], np.int32)
    for n, T in enumerate(lengths):
        s = int(start[n])
        states[n, T - 1] = s
        for t in range(T - 1, 0, -1):
            s = int(bp[n, t, s])
            states[n, t - 1] = s
    return states


def _segmented_chase(bp, t1m1, last, lengths, L, W):
    """K4's kernels in NumPy: each segment of L frames chased from W frames
    above it (from the last state where that is the last frame, else from
    the first-max argmax of T1 there), then the seams from the top segment
    down, each segment whose stored last state differs from the true one
    chased again from the true state until it meets its stored chase.
    Returns (states, frames the seams re-chased)."""
    states = np.zeros(bp.shape[:2], np.int32)
    fixed = 0
    for n, n_len in enumerate(lengths):
        segs = -(-int(n_len) // L)
        pred = np.zeros(segs, np.int64)
        for j in range(segs):
            lo, hi = j * L, min(j * L + L, n_len) - 1
            top = min(hi + W, n_len - 1)
            s = int(last[n]) if top == n_len - 1 else int(np.argmax(t1m1[n, top + 1]))
            for t in range(top, lo - 1, -1):
                if t <= hi:
                    states[n, t] = s
                if t == 0:
                    break
                s = int(bp[n, t, s])
            pred[j] = s
        e = pred[segs - 1]
        for j in range(segs - 2, -1, -1):
            lo, hi = j * L, j * L + L - 1
            if e == states[n, hi]:
                e = pred[j]
                continue
            s, met = e, False
            for t in range(hi, lo - 1, -1):
                if t < hi and s == states[n, t]:
                    met = True
                    break
                states[n, t] = s
                fixed += 1
                if t == 0:
                    break
                s = int(bp[n, t, s])
                if t == lo:
                    break
            e = pred[j] if met else s
    return states, fixed


@pytest.mark.parametrize("S,P,L,W", [(33, 128, 5, 0), (33, 128, 7, 3), (90, 128, 16, 0),
                                     (90, 128, 16, 32), (361, 384, 12, 4)])
def test_k4_pass_then_chase_and_segments_match_pallas_batch(rng, S, P, L, W):
    """K4 on the card, modelled on the CPU, against the JAX package's
    viterbi_backtrace_pallas_batch (interpreted), on ragged lengths (1 and 2
    among them) and a t1m1 with first-max ties at every step: every
    backpointer (window_backpointers_plain) then the chase from each track's
    last state; and the chase in segments of L frames with W warm-up frames
    and exact seams (W = 0 makes the seams re-chase)."""
    N, T = 8, 48
    A, t1m1 = _tie_case(rng, S, N, T)
    log_B, _ = prepare_log_params(A, np.full(S, 1.0 / S))
    lens = np.array([48, 1, 2, 47, 17, 33, 48, 31], np.int32)
    last = rng.integers(0, S, N).astype(np.int32)
    log_B_p, _ = jax_prepare(A, np.full(S, 1.0 / S), pad_to=P)
    padded = np.full((N, T, P), NEG_PAD, np.float32)
    padded[:, :, :S] = t1m1
    st_j = np.asarray(viterbi_backtrace_pallas_batch(
        jnp.asarray(padded), jnp.asarray(log_B_p), jnp.asarray(last), lens, block_frames=16,
        interpret=True))
    bp = TD.window_backpointers_plain(torch.from_numpy(log_B), torch.from_numpy(t1m1), lens).numpy()
    chased = _chase(bp, last, lens)
    segmented, fixed = _segmented_chase(bp, t1m1, last, lens, L, W)
    plain = TD.dense_backtrace(log_B, torch.from_numpy(t1m1), last, lens, segment=L,
                               warmup=W).numpy()
    for n, n_len in enumerate(lens):
        np.testing.assert_array_equal(chased[n, :n_len], st_j[n, :n_len])
        np.testing.assert_array_equal(segmented[n, :n_len], st_j[n, :n_len])
        np.testing.assert_array_equal(plain[n, :n_len], st_j[n, :n_len])
    if W == 0:
        assert fixed > 0  # the seams were exercised


@pytest.mark.parametrize("N,T,resident,L", [
    (16, 4096, 1056, 64),     # imm 722 at full width: 64 segments of 64 frames a track
    (16, 4096, 400, 164),     # fewer warps resident than 64 a track: one wave of 25
    (4, 1500, 1056, 66),      # the imm DecoderSetup's batch: 23 segments (1500 // 64)
    (1, 32768, 2244, 64),     # one long track: 512 segments of K4_MIN_SEGMENT frames
    (64, 33, 1056, 33),       # a streaming push: shorter than a segment, one chain
    (2000, 4096, 1056, 4096), # more tracks than warps resident: one chain a track
    (1, 63, 1056, 63),        # below K4_MIN_SEGMENT
    (1, 128, 1056, 64),       # two segments
])
def test_k4_segment_length(N, T, resident, L):
    """k4_segment_length: as many segments as fill the card's resident
    warps in one wave, none shorter than K4_MIN_SEGMENT frames, one chain
    where no track has two."""
    got = TD.k4_segment_length(N, T, resident)
    assert got == L
    assert got >= min(T, TD.K4_MIN_SEGMENT)
    assert N * -(-T // got) <= max(resident, N)


def test_dense_backtrace_keywords_on_the_cpu(rng):
    """On a CPU tensor K4 is its plain version whatever the segment and
    warm-up asked for; both are validated."""
    A, t1m1 = _tie_case(rng, 20, 3, 9)
    log_B, _ = prepare_log_params(A, np.full(20, 1.0 / 20))
    lens = np.array([9, 1, 4], np.int32)
    last = np.array([3, 0, 19], np.int32)
    t1m1 = torch.from_numpy(t1m1)
    want = TD.dense_backtrace_plain(torch.from_numpy(log_B), t1m1, last, lens)
    for seg, w in ((None, TD.K4_WARMUP), (1, 0), (4, 2), (100, 7)):
        assert torch.equal(TD.dense_backtrace(log_B, t1m1, last, lens, segment=seg, warmup=w), want)
    for seg, w in ((0, 0), (3, -1)):
        with pytest.raises(ValueError):
            TD.dense_backtrace(log_B, t1m1, last, lens, segment=seg, warmup=w)
