"""The port's associative-scan decode (hmm/viterbi_scan.py) against the JAX
package's and the oracle, on the CPU (template: tests/test_viterbi_scan.py).

Tolerance of the T1 rows: max-plus composition is exact in its maxima but
not in its adds, because float32 addition is not associative; the port's
scan (Hillis-Steele) adds in another order than jax.lax.associative_scan
and than the sequential recursion. Measured on these inputs: at most
1.2e-4 absolute against JAX's scan and 1.8e-4 against the sequential
recursion, at |T1| up to 560 (two and three ulps there), and 40 % of the
values differ from JAX's by an ulp or more. rtol 1e-6 (about eight ulps)
with atol 1e-5 (for the first frames, near zero) holds them. Paths are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.hmm.oracle import viterbi_oracle, viterbi_oracle_forward
from viterbi_spl_tpu.hmm.viterbi_scan import viterbi_t1_scan as jax_t1_scan
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params
from viterbi_spl_tpu_torch.hmm.viterbi_scan import viterbi_decode_scan, viterbi_t1_scan

TINY = np.finfo(np.float32).tiny


@pytest.mark.parametrize("S,T", [(17, 64), (45, 100), (90, 33), (20, 1)])
def test_scan_decode_matches_oracle(rng, S, T):
    A, pi, obs = random_hmm(rng, S, T)
    got = viterbi_decode_scan(transition_matrix=A, prob_init=pi, probs_st=obs, device="cpu")
    assert got.dtype == np.int64 and got.shape == (T,)
    np.testing.assert_array_equal(got, viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs))


@pytest.mark.parametrize("S,T", [(33, 80), (45, 100)])
def test_scan_t1_close_to_jax_and_sequential(rng, S, T):
    A, pi, obs = random_hmm(rng, S, T)
    log_B, log_pi = prepare_log_params(A, pi)
    log_A = np.ascontiguousarray(log_B.T)
    log_obs = np.log(obs.T + TINY).astype(np.float32)
    got = viterbi_t1_scan(torch.from_numpy(log_A), torch.from_numpy(log_pi),
                          torch.from_numpy(log_obs)).numpy()
    want = np.asarray(jax_t1_scan(jnp.asarray(log_A), jnp.asarray(log_pi), jnp.asarray(log_obs)))
    assert got.shape == want.shape == (T, S)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    T1_seq, _ = viterbi_oracle_forward(transition_matrix=A, prob_init=pi, probs_st=obs)
    np.testing.assert_allclose(got, T1_seq, rtol=1e-6, atol=1e-5)
