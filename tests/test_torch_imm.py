"""The port's IMM NMF (viterbi_spl_tpu_torch/models/imm.py) against the JAX
package's on the CPU, at tests/test_imm.py's SMALL config (w=512, h=64,
niters=12, R=6, P=8, K=4, bins_per_note=4).

The port draws its random inits from a torch.Generator; here both fits
start from the JAX package's own draws (its key split, passed as `init=`),
so that the two run the same NMF.

Tolerances and where they come from:
- the dictionaries, the transition matrix and the f0 grid: equal (NumPy).
- one mono and one stereo sweep on the same factors: rtol 1e-5 (float32
  matmuls in two libraries; measured up to 3e-6; atol 1e-30 only guards
  exact zeros).
- fit / fit_stereo from JAX's inits: the same number of sweeps, the error
  within rtol 1e-5, the log-energy logits within LOGIT_ATOL = 1e-4 (a
  probe of the JAX package moved its logits by at most 2.4e-6 at this
  config when SX was perturbed by 1e-7 relative; measured here 4e-6), the
  separations within 1e-4 of their peak.
- the aux functions against the sweep's tail, energies, constrained_HF0,
  process_HF0, voicing_detection: within float32 rounding, the voicing
  decisions and the constrained support equal.
- the patience loop on scripted error sequences: the JAX package's
  lax.while_loop and the reference's host loop pick the same best sweep
  and run the same number of sweeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.models import imm as JM
from viterbi_spl_tpu_torch.models import imm as TM

SMALL = dict(w=512, h=64, niters=12, R=6, P=8, K=4, bins_per_note=4)
SWEEP_RTOL = 1e-5
LOGIT_ATOL = 1e-4
MONO = ("HGAMMA", "HPHI", "HF0", "WM", "HM")
MONO_AUX = ("WPHI", "SPHI", "SF0", "SV", "SM", "hatSX")
STEREO = MONO + ("alphaL", "alphaR", "betaL", "betaR")
STEREO_AUX = ("SVL", "SVR", "SML", "SMR", "hatSXL", "hatSXR")


@pytest.fixture(scope="module")
def pair():
    return JM.IMM(JM.IMMConfig(**SMALL)), TM.IMM(TM.IMMConfig(**SMALL), device="cpu")


def synth(rng, n, sr=44100, f0=220.0):
    t = np.arange(n) / sr
    y = sum((0.6 / k) * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 6))
    return (y + 0.02 * rng.normal(size=n)).astype(np.float32)


def jax_mono_init(cfg, N, seed):
    """JAX fit's draws (models/imm.py fit: PRNGKey(seed) split in 5)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    shapes = ((cfg.P, cfg.K), (cfg.K, N), (cfg.U, N), (cfg.F, cfg.R), (cfg.R, N))
    return {k: np.array(jnp.abs(jax.random.normal(key, s)))
            for k, key, s in zip(MONO, ks, shapes)}


def jax_stereo_init(cfg, N, seed):
    """JAX fit_stereo's draws; betaL and betaR from one key (u, 1 - u)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    shapes = ((cfg.P, cfg.K), (cfg.K, N), (cfg.F, cfg.R), (cfg.R, N))
    out = {k: np.array(jnp.abs(jax.random.normal(key, s)))
           for k, key, s in zip(("HGAMMA", "HPHI", "WM", "HM"), ks, shapes)}
    out["u"] = np.array(jax.random.uniform(ks[4], (cfg.R,)))
    return out


def jax_fit(j, SX, init):
    """The JAX package's fit from `init`, as its fit runs it (frames padded
    to their bucket) -> (result dict, sweeps run)."""
    N = SX.shape[0]
    N_pad = j._frame_bucket(N)
    pad = lambda M: j._pad_frames(jnp.asarray(M), N_pad)  # noqa: E731
    st, aux, err, it = j._fit_fn(pad(SX.T), jnp.asarray(init["HGAMMA"]), pad(init["HPHI"]),
                                 pad(init["HF0"]), jnp.asarray(init["WM"]), pad(init["HM"]),
                                 jnp.int32(N))
    res = {k: np.array(np.asarray(v)[:, :N] if np.asarray(v).shape[-1] == N_pad else v)
           for k, v in zip(MONO + MONO_AUX, st + aux)}
    res["err"] = float(err)
    return res, int(it)


def jax_fit_stereo(j, SXL, SXR, sHF0, init):
    N = SXL.shape[0]
    N_pad = j._frame_bucket(N)
    pad = lambda M: j._pad_frames(jnp.asarray(M), N_pad)  # noqa: E731
    u = jnp.asarray(init["u"])
    state = (jnp.asarray(init["HGAMMA"]), pad(init["HPHI"]), pad(sHF0), jnp.asarray(init["WM"]),
             pad(init["HM"]), jnp.float32(0.5), jnp.float32(0.5), u, jnp.float32(1.0) - u)
    st, aux, err, it = j._stereo_fit_fn(pad(SXL.T), pad(SXR.T), jnp.int32(N), *state)
    res = {k: np.array(np.asarray(v)[:, :N] if np.ndim(v) == 2 and np.shape(v)[-1] == N_pad
                       else v) for k, v in zip(STEREO + STEREO_AUX, st + aux)}
    res["err"] = float(err)
    return res, int(it)


def spectrogram(j, y):
    return np.asarray(jnp.abs(j.stft.stft(y))) ** 2


def _close(got, want, name, rtol=SWEEP_RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-30, err_msg=name)


def test_dictionaries_equal_jax():
    for kw in (SMALL, {}):
        jc, tc = JM.IMMConfig(**kw), TM.IMMConfig(**kw)
        assert (tc.F, tc.U) == (jc.F, jc.U)
    j, t = JM.IMM(JM.IMMConfig(**SMALL)), TM.IMM(TM.IMMConfig(**SMALL), device="cpu")
    np.testing.assert_array_equal(t.f0s, j.f0s)
    np.testing.assert_array_equal(t.WF0, j.WF0)
    np.testing.assert_array_equal(t.WGAMMA, j.WGAMMA)
    np.testing.assert_array_equal(TM.gen_WGAMMA(1025, 30), JM.gen_WGAMMA(1025, 30))
    np.testing.assert_array_equal(t.transition_matrix, j.transition_matrix)
    np.testing.assert_array_equal(TM.klglott88_spectrum(200.0, 44100, 2048, 0.25),
                                  JM.klglott88_spectrum(200.0, 44100, 2048, 0.25))


def test_one_mono_and_one_stereo_sweep_match_jax(rng, pair):
    j, t = pair
    cfg = j.config
    SX = spectrogram(j, synth(rng, 44100 // 4))
    N = SX.shape[0]
    init = jax_mono_init(cfg, N, seed=2)
    st_j, aux_j, err_j = j._iter_fn(jnp.asarray(SX.T), *[jnp.asarray(init[k]) for k in MONO],
                                    jnp.int32(N))
    st_t, aux_t, err_t = t._iteration(torch.from_numpy(SX.T.copy()),
                                      *[torch.from_numpy(init[k]) for k in MONO])
    for got, want, name in zip(st_t + aux_t, st_j + aux_j, MONO + MONO_AUX):
        _close(got, want, name)
    _close(err_t, err_j, "err")

    sinit = jax_stereo_init(cfg, N, seed=3)
    SXR = 0.7 * SX + 1e-4
    u = sinit["u"]
    jargs = [jnp.asarray(a) for a in (sinit["HGAMMA"], sinit["HPHI"], init["HF0"], sinit["WM"],
                                       sinit["HM"], np.float32(0.6), np.float32(0.4), u, 1 - u)]
    st_j, aux_j, err_j = jax.jit(j._stereo_iteration)(jnp.asarray(SX.T), jnp.asarray(SXR.T),
                                                      *jargs, n_real=jnp.int32(N))
    st_t, aux_t, err_t = t._stereo_iteration(torch.from_numpy(SX.T.copy()),
                                             torch.from_numpy(SXR.T.copy()),
                                             *[torch.from_numpy(np.array(a)) for a in jargs])
    for got, want, name in zip(st_t + aux_t, st_j + aux_j, STEREO + STEREO_AUX):
        _close(got, want, name)
    _close(err_t, err_j, "stereo err")


def test_fit_from_jax_inits_matches_jax(rng, pair):
    """fit from the JAX package's draws: the same sweeps, the same error
    (rtol 1e-5), every factor close, and the log-energy logits within
    LOGIT_ATOL."""
    j, t = pair
    SX = spectrogram(j, synth(rng, 44100 // 4))
    init = jax_mono_init(j.config, SX.shape[0], seed=0)
    want, want_sweeps = jax_fit(j, SX, init)
    got = t.fit(SX, init=init)
    assert got["sweeps"] == want_sweeps
    assert got["err"] == pytest.approx(want["err"], rel=SWEEP_RTOL)
    for name in MONO + MONO_AUX:
        _close(got[name], want[name], name, rtol=1e-4)
    lg, lw = t.logits_from_fit(got, SX), j.logits_from_fit(want, SX)
    assert lg.shape == lw.shape == (j.config.U, SX.shape[0]) and lg.dtype == np.float32
    np.testing.assert_allclose(lg, lw, rtol=0, atol=LOGIT_ATOL)
    # the logits of the same fit: equal up to the matmul's rounding
    np.testing.assert_allclose(t.logits_from_fit({k: torch.from_numpy(want[k]) for k in MONO + MONO_AUX}, SX),
                               lw, rtol=0, atol=1e-5)


def test_fit_stereo_and_separation_match_jax(rng, pair):
    j, t = pair
    yL = synth(rng, 44100 // 4)
    yR = 0.6 * yL + 0.01 * rng.normal(size=len(yL)).astype(np.float32)
    XL, XR = np.array(j.stft.stft(yL)), np.array(j.stft.stft(yR))
    SXL, SXR = np.abs(XL) ** 2, np.abs(XR) ** 2
    mono, _ = jax_fit(j, SXL, jax_mono_init(j.config, SXL.shape[0], seed=0))
    states = np.argmax(mono["HF0"], axis=0)
    sHF0 = t.constrained_HF0(torch.from_numpy(mono["HF0"]), states)
    np.testing.assert_array_equal(sHF0, j.constrained_HF0(mono["HF0"], states))
    init = jax_stereo_init(j.config, SXL.shape[0], seed=0)
    want, want_sweeps = jax_fit_stereo(j, SXL, SXR, sHF0, init)
    got = t.fit_stereo(SXL, SXR, sHF0, init=init)
    assert got["sweeps"] == want_sweeps
    assert got["err"] == pytest.approx(want["err"], rel=SWEEP_RTOL)
    for name in STEREO + STEREO_AUX:
        _close(got[name], want[name], name, rtol=1e-4)
    assert abs(float(got["alphaL"] + got["alphaR"]) - 1) < 1e-6
    sg = t.separate_stereo(torch.from_numpy(XL), torch.from_numpy(XR), got)
    sw = j.separate_stereo(XL, XR, want)
    for key in ("melody", "accompaniment"):
        for g, w in zip(sg[key], sw[key]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4 * np.abs(w).max())
    rec = (sg["melody"][0] + sg["accompaniment"][0])[: len(yL)]
    assert np.mean((rec - yL) ** 2) / np.mean(yL**2) < 0.05  # tests/test_imm.py's bound


def test_generator_draws_and_the_shared_beta_key(rng, pair):
    """Without init, the inits are |N(0, 1)| draws from the generator in
    the documented order, the same for a seed and for a generator seeded
    alike; betaR = 1 - betaL from one draw at the start."""
    _, t = pair
    cfg = t.config
    SX = spectrogram(pair[0], synth(rng, 44100 // 8))
    N = SX.shape[0]
    a = t.fit(SX, seed=4)
    b = t.fit(SX, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    draws = {k: torch.randn(s, generator=g).abs() for k, s in zip(
        MONO, ((cfg.P, cfg.K), (cfg.K, N), (cfg.U, N), (cfg.F, cfg.R), (cfg.R, N)))}
    c = t.fit(SX, init=draws)
    for k in MONO:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    sHF0 = t.constrained_HF0(a["HF0"], np.argmax(a["HF0"].numpy(), axis=0))
    one = dataclasses.replace(cfg, niters=1)
    t1 = TM.IMM(one, device="cpu")
    g = torch.Generator().manual_seed(9)
    shapes = ((cfg.P, cfg.K), (cfg.K, N), (cfg.F, cfg.R), (cfg.R, N))
    init = {k: torch.randn(s, generator=g).abs()
            for k, s in zip(("HGAMMA", "HPHI", "WM", "HM"), shapes)}
    init["u"] = torch.rand((cfg.R,), generator=g)
    s1 = t1.fit_stereo(SX, SX, sHF0, seed=9)
    s2 = t1.fit_stereo(SX, SX, sHF0, init=init)
    for k in STEREO:
        assert torch.equal(s1[k], s2[k]), k
    assert s1["sweeps"] == 1


@pytest.mark.parametrize("errs,niters", [
    ([5.0, 4.0, 4.0, 4.0, 3.0], 12),          # a tie is no improvement: stop at the second
    ([5.0, 4.0, 4.5, 3.0, 3.5, 3.6, 1.0], 12),  # one miss, then improve, then two misses
    ([5.0, 4.0, 3.0, 2.0, 1.0, 0.5], 4),      # niters cuts an improving run
    ([7.0, 8.0, 9.0, 1.0], 12),               # the first sweep is accepted, then patience
    ([float("nan"), 2.0, 1.0, 0.5], 12),      # a NaN first sweep is kept, nothing beats it
])
def test_patience_loop_semantics_match_jax(pair, errs, niters):
    """The port's patience loop, the JAX package's lax.while_loop and the
    reference's host loop on a scripted error sequence (sweep k returns
    errs[k] and state k + 1): the same best state, error and sweeps run."""
    j, t = pair
    cfg = dataclasses.replace(t.config, niters=niters)
    table = np.array(errs + [99.0] * 16, np.float32)

    tt = TM.IMM.__new__(TM.IMM)
    tt.config = cfg
    best_t, err_t, it_t = tt._keep_best_while(
        lambda s: ((s[0] + 1,), torch.tensor(table[int(s[0])])), (torch.zeros((), dtype=torch.int64),))

    jj = JM.IMM.__new__(JM.IMM)
    jj.config = dataclasses.replace(j.config, niters=niters)
    jt = jnp.asarray(table)
    best_j, err_j, it_j = jax.jit(lambda s0: jj._keep_best_while(
        lambda s: ((s[0] + 1,), jt[s[0]]), (s0,)))(jnp.int32(0))

    min_err, since, best, it = None, 0, None, 0  # tests/test_imm.py:177's host loop
    for k in range(niters):
        it += 1
        err = float(table[k])
        if min_err is None or err < min_err:
            min_err, since, best = err, 0, k + 1
        else:
            since += 1
        if since == cfg.patient_iters:
            break
    assert it_t == int(it_j) == it
    assert int(best_t[0]) == int(best_j[0]) == best
    np.testing.assert_array_equal(float(err_t), float(err_j))


def test_aux_functions_equal_the_sweep_tail(rng, pair):
    """_aux_from_state / _stereo_aux_from_state recompute the spectra the
    sweeps' tails assemble (the fits return them), as in
    tests/test_imm.py::test_aux_from_state_matches_iteration_tail."""
    j, t = pair
    SX = torch.from_numpy(spectrogram(j, synth(rng, 44100 // 8)).T.copy())
    init = jax_mono_init(j.config, SX.shape[1], seed=7)
    state = [torch.from_numpy(init[k]) for k in MONO]
    new_state, aux, _ = t._iteration(SX, *state)
    for got, want, name in zip(t._aux_from_state(*new_state), aux, MONO_AUX):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-8, msg=name)
    stereo = state + [torch.tensor(0.6), torch.tensor(0.4), torch.rand(j.config.R),
                      torch.rand(j.config.R)]
    new_state, aux, _ = t._stereo_iteration(SX, SX * 0.8, *stereo)
    for got, want, name in zip(t._stereo_aux_from_state(*new_state), aux, STEREO_AUX):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-8, msg=name)


def test_energies_process_hf0_and_voicing_match_jax(rng, pair):
    """On one JAX fit (a tone, then near-silence): the Wiener energies
    (float32 rounding), process_HF0, constrained_HF0 and the voicing
    decisions (equal), melody_f0s (equal)."""
    j, t = pair
    y = np.concatenate([synth(rng, 44100 // 4), 0.001 * rng.normal(size=44100 // 8).astype(np.float32)])
    SX = spectrogram(j, y)
    fit, _ = jax_fit(j, SX, jax_mono_init(j.config, SX.shape[0], seed=1))
    tfit = {k: torch.from_numpy(v) for k, v in fit.items() if k != "err"}
    E_t, E_j = t.energies_for_f0s(tfit, SX), j.energies_for_f0s(fit, SX)
    np.testing.assert_allclose(E_t, E_j, rtol=1e-5, atol=1e-6 * E_j.max())
    lo_t, lo_j = t.process_HF0(tfit["HF0"]), j.process_HF0(fit["HF0"])
    assert lo_t.dtype == lo_j.dtype
    np.testing.assert_array_equal(lo_t, lo_j)
    floored = fit["HF0"].copy()
    floored[floored > 0] = np.maximum(floored[floored > 0], 1e-39)  # log(min) < -87: the floor
    floored[0, 0] = 1e-39
    np.testing.assert_array_equal(t.process_HF0(floored), j.process_HF0(floored))
    states = np.argmax(fit["HF0"], axis=0)
    states[::7] = j.config.U  # unvoiced frames
    np.testing.assert_array_equal(t.constrained_HF0(tfit["HF0"], states),
                                  j.constrained_HF0(fit["HF0"], states))
    v_t = t.voicing_detection(torch.from_numpy(SX), tfit, states)
    v_j = j.voicing_detection(SX, fit, states)
    np.testing.assert_array_equal(v_t, v_j)
    assert 0 < v_t.mean() < 1
    np.testing.assert_array_equal(t.melody_f0s(states, v_t), j.melody_f0s(states, v_j))


def patch_fits_to_jax_draws(monkeypatch):
    """Make the port's IMM.fit and fit_stereo start from the JAX package's
    draws for the seed they are given (the app and CLI tests run both
    packages' chains on the same NMF)."""
    fit, fit_stereo = TM.IMM.fit, TM.IMM.fit_stereo

    def mono(self, SX, seed=0, generator=None, init=None):
        return fit(self, SX, init=jax_mono_init(self.config, SX.shape[0], seed))

    def stereo(self, SXL, SXR, sHF0, seed=0, generator=None, init=None):
        return fit_stereo(self, SXL, SXR, sHF0, init=jax_stereo_init(self.config, SXL.shape[0], seed))

    monkeypatch.setattr(TM.IMM, "fit", mono)
    monkeypatch.setattr(TM.IMM, "fit_stereo", stereo)
