"""The port's fused serving path (hmm/obs_fused.py, K9's plain version, the
fused decode API, DecoderSetup(fused_obs=True) and the CLI's --fused-obs)
against the JAX package's, on the CPU, with inputs from a numpy seed. The
JAX side runs its Pallas kernels interpreted, as tests/test_obs_pallas.py
runs them.

Tolerance of the observations (hmm/obs_fused.py::obs_contract: the
contract of tests/test_obs_pallas.py:40-61, plus what a second framework
adds):
- lanes at log TINY (non-peaks) are bit-equal;
- above -80, rtol 2e-4, with atol 1e-6 where a scaled softmax lane's
  d - log(denom) - log(prior) cancels to near zero (the operands are a few
  units, one ulp of them is 4.8e-7: measured 4.8e-7 with another seed);
- in the floor region, at most 0.70 (log 2) absolute;
- the unvoiced lane: rtol 1e-6 is the JAX package's own bound; the
  sigmoid (shaun) and the denominators' summation order (softmax) differ
  between XLA and PyTorch by an ulp or two, which log(1 - p + TINY)
  amplifies where p is near 1; measured at most 1.6e-7 relative on these
  inputs, so the bound stays 1e-6. For the softmax models the contract
  adds (p + 1) 2^-24 absolute, p the terms of the frame's denominator:
  a float32 sum of p terms in another order is that far off in its log,
  which a relative bound misses where the log is near 0 (the CUDA
  kernel's 0.0817 against 0.0817001 at 108 terms on an H100:
  scripts/gpu_obs_unvoiced_probe.py).
Two XLA-on-CPU artefacts are kept out of the shared inputs and pinned by
their own test: where p_voiced rounds to 1, the interpreted kernel's
unvoiced lane is -inf (XLA folds (1 - p) + TINY into (1 + TINY) - p), and
where exp underflows into float32 denormals (a logit gap above 87) XLA
flushes them to zero while PyTorch and CUDA keep them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_hmm
from test_torch_decode import _cli_inputs, _jax_setup, _logits
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.cli import decode as JD
from viterbi_spl_tpu.hmm import params as JP
from viterbi_spl_tpu.hmm.obs import shaun_observation_probs as jax_shaun_probs
from viterbi_spl_tpu.hmm.obs_pallas import (
    pad_logits_reflect,
    shaun_log_obs_pallas,
    softmax_log_obs_pallas,
)
from viterbi_spl_tpu.hmm.viterbi import TINY
from viterbi_spl_tpu.hmm.viterbi import prepare_log_params as jax_log_params
from viterbi_spl_tpu.hmm.viterbi_banded import (
    extract_banded_structure as jax_banded_structure,
    viterbi_forward_pallas_banded_batch_obs,
)
from viterbi_spl_tpu.hmm.viterbi_pallas import viterbi_decode_batch_pallas_fused_obs
from viterbi_spl_tpu_torch.cli import decode as TD
from viterbi_spl_tpu_torch.harness import evaluate as TE
from viterbi_spl_tpu_torch.hmm import obs_fused as OF
from viterbi_spl_tpu_torch.hmm import viterbi_banded as TB
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TVD

METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")
LOG_TINY = np.float32(np.log(np.float32(TINY)))
N, T = 8, 32
RAGGED = np.asarray([T, T - 5, T - 1, 7, T, 3, T - 2, T], np.int32)


def _lane_pad(n_bins, spw):
    return ((n_bins + 2 * spw + 127) // 128) * 128


def _priors(rng, n_bins):
    pri = rng.random(n_bins + 1).astype(np.float32) + 0.1
    return pri / pri.sum()


@pytest.mark.parametrize("n_bins,spw", [(120, 3), (90, 16), (100, 16)])
@pytest.mark.parametrize("method", METHODS)
def test_plain_obs_matches_pallas_kernels(rng, n_bins, spw, method):
    """(a) K5/K6's plain versions against the interpreted Pallas kernels on
    the JAX package's own reflect-padded layout, sliced to [..., :S]."""
    lg = OF.contract_logits(rng, N, T, n_bins)
    x = torch.from_numpy(lg)
    padded = pad_logits_reflect(jnp.asarray(lg), spw, _lane_pad(n_bins, spw))
    if method == "shaun":
        want = np.asarray(shaun_log_obs_pallas(padded, n_bins, spw, 0.3, block_frames=16))
        got = OF.shaun_log_obs_plain(x, spw, OF.shaun_params(0.3))
        obs = dict(method=method, spw=spw, threshold_logit=0.3)
    else:
        pri, scaled = _priors(rng, n_bins), method == "softmax-scaled"
        want = np.asarray(softmax_log_obs_pallas(padded, n_bins, spw, 0.7, pri, scaled,
                                                 block_frames=16))
        params, log_prior = OF.softmax_params(0.7, pri, n_bins, scaled)
        got = OF.softmax_log_obs_plain(x, spw, params, log_prior)
        obs = dict(method=method, spw=spw, threshold_logit=0.7, init_probs=pri)
    want = want[..., : n_bins + 1]
    assert got.shape == (N, T, n_bins + 1) and got.dtype == torch.float32
    got = got.numpy()
    res = OF.obs_contract(got, want, softmax=method != "shaun")
    assert res["ok"], res
    np.testing.assert_array_equal(got[1, 5], np.append(np.full(n_bins, LOG_TINY), got[1, 5, -1]))
    # the obs-dict dispatch and the CPU wrapper are the plain version
    np.testing.assert_array_equal(OF.log_obs_plain(x, obs).numpy(), got)
    np.testing.assert_array_equal(OF.log_obs(x, obs).numpy(), got)


def test_saturated_voicing_gives_log_tiny_not_minus_inf():
    """A peak far above the threshold rounds p_voiced to 1: the unvoiced
    lane is log(0 + TINY), as the JAX package's default path computes it
    (np.log of the shaun probabilities plus TINY); never -inf."""
    lg = np.tile(np.arange(60, dtype=np.float32), (1, 2, 1))
    got = OF.shaun_log_obs_plain(torch.from_numpy(lg), 3, OF.shaun_params(0.3)).numpy()
    want = np.log(np.asarray(jax_shaun_probs(jnp.asarray(lg[0]), 0.3, 3)) + TINY)
    assert got[0, 0, 60] == LOG_TINY
    np.testing.assert_array_equal(got[0, :, 60], want[:, 60])
    assert np.isfinite(got).all()


def test_host_params_match_the_jax_package():
    np.testing.assert_array_equal(
        OF.reflect_index(7, 3), np.asarray([3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 5, 4, 3])
    )
    th, offset, scale = OF.shaun_params(0.25, 0.8, 2.0)
    p32 = jnp.asarray(0.8, jnp.float32)
    assert offset == np.float32(jnp.log(p32 / (1.0 - p32))) and th == np.float32(0.25)
    pri = np.full(5, 0.2, np.float32)
    (vth, prior_uv), log_prior = OF.softmax_params(0.7, pri, 4, scaled=True)
    np.testing.assert_array_equal(log_prior, np.log(pri[:4]))
    assert prior_uv == np.float32(0.2) and vth == np.float32(0.7)
    (_, prior_uv), log_prior = OF.softmax_params(0.7, None, 4, scaled=False)
    assert prior_uv == 1.0 and not log_prior.any()
    assert OF.LOG_TINY_F32 == TB.LOG_TINY
    with pytest.raises(ValueError, match="spw"):
        OF.reflect_index(4, 4)


def _shaped(rng, n_bins=60, d_max=6):
    q = np.clip(n_bins // 2 + np.cumsum(rng.integers(-2, 3, 2000)), 0, n_bins - 1)
    voiced = np.repeat(rng.random(101) > 0.3, 20)[:2000]
    stats = JP.count_statistics([np.where(voiced, q, n_bins)], n_bins)
    A = JP.shape_transition_matrix(stats.transition_counts, stats.switch, n_bins, d_max, floor=2)
    return A, JP.shape_init_probs(stats.p_steady)


def _obs_cfg(rng, method, n_bins, spw=3, th=0.2):
    if method == "shaun":
        return dict(method="shaun", spw=spw, threshold_logit=th)
    return dict(method=method, spw=spw, threshold_logit=th, init_probs=_priors(rng, n_bins))


@pytest.mark.parametrize("method", METHODS)
def test_plain_k9_matches_pallas_forward_obs(rng, method):
    """(b) K9's plain version against viterbi_forward_pallas_banded_batch_obs,
    full and ragged lengths: equal states on tie-free logits (through the
    port's plain backtrace), t1_last and t1m1 within rtol 1e-5 and atol
    1e-5 (T1 sums up to T observations, each within a few ulps of the JAX
    value, and passes near zero, where one ulp of its terms of up to ~100
    is 7.6e-6: measured 7.2e-7 absolute there)."""
    n_bins, spw, P = 60, 3, 128
    A, pi = _shaped(rng, n_bins)
    _, log_pi_p = jax_log_params(A, pi, pad_to=P)
    bs_j = jax_banded_structure(A, P)
    bs_t = TB.extract_banded_structure(A)
    log_pi = log_pi_p[: n_bins + 1]
    lg = rng.normal(-2, 1, (N, T, n_bins)).astype(np.float32)
    padded = pad_logits_reflect(jnp.asarray(lg), spw, P)
    obs = _obs_cfg(rng, method, n_bins, spw)
    for lens in (np.full(N, T, np.int32), RAGGED):
        t1_j, t1m1_j = viterbi_forward_pallas_banded_batch_obs(
            bs_j, jnp.asarray(log_pi_p), padded, jnp.asarray(lens), obs, block_frames=16
        )
        t1_j, t1m1_j = np.asarray(t1_j)[:, : n_bins + 1], np.asarray(t1m1_j)[..., : n_bins + 1]
        t1_t, t1m1_t = TB.banded_forward_obs_plain(bs_t, log_pi, torch.from_numpy(lg), lens, obs)
        np.testing.assert_allclose(t1_t.numpy(), t1_j, rtol=1e-5, atol=1e-5)
        for n, L in enumerate(lens):
            np.testing.assert_allclose(t1m1_t[n, :L].numpy(), t1m1_j[n, :L], rtol=1e-5, atol=1e-5)
        states = [
            TB.banded_backtrace_plain(bs_t, rows, np.argmax(last, axis=1), lens).numpy()
            for last, rows in ((t1_t.numpy(), t1m1_t), (t1_j, torch.from_numpy(t1m1_j.copy())))
        ]
        for n, L in enumerate(lens):
            np.testing.assert_array_equal(states[0][n, :L], states[1][n, :L])
        # the CPU wrapper is the plain version
        again = TB.banded_forward_obs(bs_t, log_pi, torch.from_numpy(lg), lens, obs)
        np.testing.assert_array_equal(again[0].numpy(), t1_t.numpy())


@pytest.mark.parametrize("kind", ["shaped", "dense"])
@pytest.mark.parametrize("method", METHODS)
def test_fused_decode_api_matches_jax(rng, kind, method):
    """(c) viterbi_decode_batch_fused_obs on the CPU against
    viterbi_decode_batch_pallas_fused_obs: equal paths on clear-signal
    tracks, ragged lengths."""
    n_bins = 60
    if kind == "shaped":
        A, pi = _shaped(rng, n_bins)
    else:
        A, pi, _ = random_hmm(rng, n_bins + 1, 4)
    lg = np.stack([_logits(rng, n_bins, T) for _ in range(N)])
    obs = _obs_cfg(rng, method, n_bins, th=0.0)
    P = 128
    want = np.asarray(viterbi_decode_batch_pallas_fused_obs(
        transition_matrix=A, prob_init=pi,
        logits_padded=pad_logits_reflect(jnp.asarray(lg), 3, P),
        lengths=jnp.asarray(RAGGED), obs=obs, block_frames=16,
    ))
    got = TVD.viterbi_decode_batch_fused_obs(
        transition_matrix=A, prob_init=pi, logits=torch.from_numpy(lg), lengths=RAGGED, obs=obs
    )
    assert got.dtype == torch.int32 and got.shape == (N, T)
    for n, L in enumerate(RAGGED):
        np.testing.assert_array_equal(got[n, :L].numpy(), want[n, :L])


@pytest.mark.parametrize("method", METHODS)
def test_decoder_setup_fused_obs_matches_jax(rng, method):
    """(d) DecoderSetup.from_numpy(..., fused_obs=True) against the JAX
    package's DecoderSetup(fused_obs=True): equal voiced/bins."""
    js = dataclasses.replace(_jax_setup("dense", method, rng), fused_obs=True)
    ts = TE.DecoderSetup.from_numpy(dataclasses.asdict(js), device="cpu")
    assert ts.fused_obs
    logits = [_logits(rng, js.n_bins, L) for L in (70, 45, 9)]
    for (jv, jb), (tv, tb) in zip(js.decode_batch(logits), ts.decode_batch(logits)):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tb, jb)
    with pytest.raises(ValueError, match="mesh"):
        TE.DecoderSetup.from_numpy(dict(dataclasses.asdict(js), mesh=object()), device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_decode_cli_fused_obs_matches_jax_and_default(tmp_path, rng, method):
    """(e) The port's CLI with --fused-obs --device cpu against the JAX CLI
    with --fused-obs, and against the port's own default path: the same
    voiced and bins on clear-signal tracks (template:
    tests/test_cli_decode.py:106-123)."""
    paths = _cli_inputs(tmp_path, rng)
    common = [str(p) for p in paths] + [
        "--family", "tonet", "--artifacts", str(tmp_path / "hmm"),
        "--method", method, "--format", "npz", "--batch", "2",
    ]
    fused = TD.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu", "--fused-obs"])
    default = TD.main(common + ["--out", str(tmp_path / "d"), "--device", "cpu"])
    jax_fused = JD.main(common + ["--out", str(tmp_path / "j"), "--fused-obs"])
    for f, d, j in zip(fused, default, jax_fused):
        for other in (d, j):
            np.testing.assert_array_equal(f["voiced"], other["voiced"])
            np.testing.assert_array_equal(f["bins"], other["bins"])
    for p in paths:
        t = np.load(tmp_path / "t" / f"{p.stem}.npz")
        assert t["voiced"].shape == (np.load(p).shape[0],)




@pytest.mark.parametrize("n_bins,spw,layout", [
    (360, 5, (2, 15, 6)),     # tonet 361 serving: two blocks an SM, 30 consumers
    (721, 16, (2, 15, 2)),    # jdc 722 serving
    (721, 20, (2, 15, 2)),    # imm's spw
    (2, 1, (2, 15, 6)),       # the smallest input
    (1024, 1, (1, 15, 4)),    # the widest: one block an SM
    (1024, 1023, (1, 7, 3)),  # the widest window: fewer consumers' rows fit
])
def test_obs_layout_fits_the_sm(n_bins, spw, layout):
    """K5/K6's layout rule: the most consumer warps an SM, then the most
    stages, within the H100's shared memory (each block at most 227 KB; the
    SM's 228 KB less 1 KB reserved a block), at least two stages."""
    got = OF.obs_layout(n_bins, spw)
    assert got == layout
    blocks, consumers, stages = got
    smem = OF.obs_smem_bytes(n_bins, spw, consumers, stages)
    assert smem <= OF.SMEM_PER_BLOCK and blocks * (smem + 1024) <= OF.SMEM_PER_SM
    assert consumers in OF.OBS_CONSUMERS and 2 <= stages <= OF.OBS_MAX_STAGES


def test_obs_layout_refuses_a_window_it_cannot_stage():
    with pytest.raises(ValueError):
        OF.obs_layout(360, 360)
    with pytest.raises(ValueError):
        OF.obs_layout(360, 0)


@pytest.mark.parametrize("layout", [(1, 16, 2), (1, 0, 2), (0, 15, 2), (2, 15, 1), (1, 9, 1)])
def test_obs_kernel_refuses_layouts_it_cannot_run(layout):
    """K5/K6 refuse, before any launch, more consumer warps than a block
    takes and fewer stages than a consumer's stride spans (a wait on a
    stage two phases behind would pass)."""
    lg = torch.zeros((2, 8, 360), dtype=torch.float32)
    with pytest.raises(ValueError, match="consumer warps"):
        OF._launch(lg, 5, OF.shaun_params(0.0), layout=layout)
