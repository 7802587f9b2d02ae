"""The port's fixed-lag streaming decoder (hmm/streaming.py) against the
oracle, the JAX package's streams and itself, on the CPU (template:
tests/test_streaming.py). Exact throughout: the port's pool runs the
plain versions of the batched decode kernels here, whose DP only adds and
takes maxima, and the JAX side is fed the same NumPy log observations.
"""

import numpy as np
import pytest

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.hmm.oracle import viterbi_oracle
from viterbi_spl_tpu.hmm.streaming import StreamingViterbiBatch as JaxBatch
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TVD
from viterbi_spl_tpu_torch.hmm.streaming import (
    StreamingDrain,
    StreamingViterbi,
    StreamingViterbiBatch,
)

TINY = np.finfo(np.float32).tiny


def _stream(sv, obs_ts, hop):
    out = [sv.push(obs_ts[i:i + hop]) for i in range(0, len(obs_ts), hop)]
    out.append(sv.flush())
    return np.concatenate(out)


def _pool(svb, obs_batch, hop, **kw):
    out = [svb.push(obs_batch[:, i:i + hop], **kw) for i in range(0, obs_batch.shape[1], hop)]
    out.append(svb.flush())
    return np.concatenate([o for o in out if o.shape[1]], axis=1)


def _melody_hmm(rng, n_bins, d_max, switch):
    q = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-2, 3, 1500)), 0, n_bins - 1)]
    stats = JP.count_statistics(q, n_bins)
    A = JP.shape_transition_matrix(stats.transition_counts, np.asarray(switch), n_bins, d_max, 2)
    return A, JP.shape_init_probs(stats.p_steady, p_th=1e-4)


@pytest.mark.parametrize("chunks", ["ragged", "single_frames"])
def test_large_lag_equals_offline(rng, chunks):
    """With lag >= length the stream is the offline decode, for ragged
    chunks and for single-frame pushes."""
    S, T = (40, 120) if chunks == "ragged" else (15, 40)
    A, pi, obs = random_hmm(rng, S, T)
    expected = viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs)
    sv = StreamingViterbi(A, pi, lag=T + 10 if chunks == "ragged" else T, device="cpu")
    if chunks == "ragged":
        out = [sv.push(c) for c in np.split(obs.T, [13, 50, 51, 100]) if len(c)]
        got = np.concatenate(out + [sv.flush()])
    else:
        got = _stream(sv, obs.T, 1)
    assert got.dtype == np.int32 and len(got) == T
    np.testing.assert_array_equal(got, expected)


def test_emission_cadence(rng):
    S, T = 20, 100
    A, pi, obs = random_hmm(rng, S, T)
    sv = StreamingViterbi(A, pi, lag=30, device="cpu")
    emitted = 0
    for i in range(0, T, 10):
        emitted += len(sv.push(obs.T[i:i + 10]))
        assert emitted == max(0, (i + 10) - 30)  # never within the lag window
    emitted += len(sv.flush())
    assert emitted == T


def test_small_lag_agreement_on_melody_hmm(rng):
    n_bins = 50
    A, pi = _melody_hmm(rng, n_bins, 5, [[0.97, 0.03], [0.04, 0.96]])
    T = 600
    path = np.clip(25 + np.cumsum(rng.integers(-1, 2, T)), 0, n_bins - 1)
    obs = np.full((n_bins + 1, T), 1e-3, np.float32)
    obs[path, np.arange(T)] = 1.0
    obs /= obs.sum(0, keepdims=True)
    expected = viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs)
    got = _stream(StreamingViterbi(A, pi, lag=64, device="cpu"), obs.T, 37)
    assert len(got) == T
    assert float(np.mean(got == expected)) > 0.97


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_pool_equals_single_streams_and_offline(rng, kind):
    """The pool's streams equal single streams bit for bit at a finite lag
    (synchronized hops, the flush tail), and with lag >= length equal the
    offline batch decode."""
    M, T, lag, hop = 4, 90, 25, 10
    if kind == "banded":
        A, pi = _melody_hmm(rng, 29, 5, [[0.98, 0.02], [0.02, 0.98]])
    else:
        A, pi, _ = random_hmm(rng, 30, 4)
    S = A.shape[0]
    obs_batch = np.stack([random_hmm(rng, S, T)[2].T for _ in range(M)])
    singles = [_stream(StreamingViterbi(A, pi, lag=lag, device="cpu"), obs_batch[m], hop)
               for m in range(M)]
    got = _pool(StreamingViterbiBatch(A, pi, n_streams=M, lag=lag, device="cpu"), obs_batch, hop)
    assert got.shape == (M, T)
    for m in range(M):
        np.testing.assert_array_equal(got[m], singles[m])
    svb = StreamingViterbiBatch(A, pi, n_streams=M, lag=T + 5, device="cpu")
    assert svb.push(obs_batch).shape == (M, 0)
    offline = TVD.viterbi_decode_batch(transition_matrix=A, prob_init=pi,
                                       probs_st_list=list(obs_batch.transpose(0, 2, 1)),
                                       device="cpu")
    np.testing.assert_array_equal(svb.flush(), np.stack(offline))


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_pool_matches_jax_kernel_path(rng, kind):
    """The port's pool gives the JAX package's StreamingViterbiBatch states
    on its kernel path (M=8, Pallas interpreted, carry injection) at the
    same lag and hops, on a banded melody HMM and a dense random one."""
    M, T, lag, hop = 8, 96, 30, 16
    if kind == "banded":
        A, pi = _melody_hmm(rng, 40, 5, [[0.98, 0.02], [0.02, 0.98]])
    else:
        A, pi, _ = random_hmm(rng, 41, 4)
    S = A.shape[0]
    log_obs = np.stack([np.log(random_hmm(rng, S, T)[2].T + TINY) for _ in range(M)])
    log_obs = log_obs.astype(np.float32)
    want = _pool(JaxBatch(A, pi, n_streams=M, lag=lag, use_kernels=True), log_obs, hop,
                 is_log=True)
    got = _pool(StreamingViterbiBatch(A, pi, n_streams=M, lag=lag, device="cpu"), log_obs, hop,
                is_log=True)
    np.testing.assert_array_equal(got, want)


def test_drain_identical_to_per_push(rng):
    """StreamingDrain only batches readbacks: the same states as per-push
    draining, with drain boundaries before the lag fills and at the tail."""
    S, T, M, lag, hop = 25, 140, 8, 33, 10
    obs_batch = np.stack([random_hmm(rng, S, T)[2].T for _ in range(M)])
    A, pi, _ = random_hmm(rng, S, 4)
    ref = _pool(StreamingViterbiBatch(A, pi, n_streams=M, lag=lag, device="cpu"), obs_batch, hop)
    for every in (1, 3, 8):
        drain = StreamingDrain(StreamingViterbiBatch(A, pi, n_streams=M, lag=lag, device="cpu"),
                               every=every)
        got = [drain.push(obs_batch[:, i:i + hop]) for i in range(0, T, hop)]
        got.append(drain.flush())
        got = np.concatenate([o for o in got if o is not None and o.shape[1]], axis=1)
        np.testing.assert_array_equal(got, ref)
