"""IMM, Durrieu's source/filter NMF melody model, in PyTorch (counterpart of
viterbi_spl_tpu/models/imm.py).

Re-design of imm/tf_imm.py (mono melody chain):
  hatSX = (WGAMMA @ HGAMMA @ HPHI) * (WF0 @ HF0) + WM @ HM
with multiplicative Itakura-Saito updates for HF0, HPHI, HM, HGAMMA, WM per
sweep (exact update order and renormalizations of tf_imm_fn,
imm/tf_imm.py:205-352), 100 sweeps with patience-2 early stopping on the IS
divergence. Every update is a dense float32 matmul (torch.matmul, TF32 off
on the card: `eps` = 1e-20 sits inside divisions and the divergence) on
the device the instance was made for (CUDA unless the caller asks for the
CPU).

Dictionaries (NumPy, as in the JAX package):
- WF0: KLGLOTT88 glottal-flow spectra per f0 on a 20-bins-per-semitone grid
  100..800 Hz (U=721), column-max normalized (imm/wf0.py:4-59,
  imm/tf_imm.py:168-188),
- WGAMMA: 75%-overlapping Hann filterbank, P=30 bases (imm/wgamma.py:4-41).

The random inits come from an explicit CPU `torch.Generator` (the same
factors on every device), or are passed in (`init=`). The fit runs at the
track's own frame count: the JAX package's frame buckets and padded-column
pinning exist for XLA's compiled shapes only, and without them only the
reduction order differs.

Melody outputs:
- `energies_for_f0s`: per-bin Wiener energies, one matmul (the reference
  loops u=0..720, imm/tf_imm.py:636-657),
- `logits`: log10 energies + 6 over the 721-bin grid (:659-678),
- `process_HF0`: log-HF0 observations for the "original" decode (:71-88),
- `voicing_detection`: melody-band Wiener energies + cumulative-energy
  threshold 5.84e-4 (:705-756),
- `separate_stereo`: the stereo pass's Wiener masks and ISTFT (:354-618).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..frontend.stft import SinebellSTFT
from ..hmm.params import imm_transition_matrix
from ..utils import resolve_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class IMMConfig:
    w: int = 2048
    h: int = 256
    fs: int = 44100
    niters: int = 100
    patient_iters: int = 2
    R: int = 40  # accompaniment bases
    P: int = 30  # filterbank bases
    K: int = 10  # filter shapes
    fmin: float = 100.0
    fmax: float = 800.0
    bins_per_note: int = 20
    Oq: float = 0.25
    eps: float = 1e-20

    @property
    def F(self) -> int:
        return self.w // 2 + 1

    @property
    def U(self) -> int:
        u = 12 * self.bins_per_note * np.log2(self.fmax / self.fmin)
        return int(np.ceil(u)) + 1


def klglott88_spectrum(f0: float, fs: int, n_samples: int, Oq: float) -> np.ndarray:
    """Power spectrum of a KLGLOTT88 glottal pulse train windowed by a
    sinebell (imm/wf0.py:18-59, constant-E variant)."""
    j2pi = 1j * 2 * np.pi
    n_hs = int(np.floor(fs / 2.0 / f0))
    s = j2pi * np.arange(1, n_hs + 1) * Oq
    one_over_s = 1.0 / s
    ems = np.exp(-s)
    chs = Oq * one_over_s * (
        ems + 2.0 * (1.0 + 2.0 * ems) * one_over_s - 6.0 * (1.0 - ems) * one_over_s**2
    )
    ts = np.arange(n_samples)
    hf0t = (np.arange(1, n_hs + 1) * (f0 / float(fs)))[:, None] * ts[None, :]
    waveform = (chs.real[:, None] * np.cos(2 * np.pi * hf0t)) - (
        chs.imag[:, None] * np.sin(2 * np.pi * hf0t)
    )
    waveform = waveform.sum(axis=0)
    window = np.sin(np.pi * np.arange(n_samples) / n_samples)
    return np.abs(np.fft.rfft(waveform * window)) ** 2


def imm_f0s(config: IMMConfig) -> np.ndarray:
    """The f0 grid [U]: fmin * 2**(u / (12 * bins_per_note))."""
    return config.fmin * 2.0 ** (np.arange(config.U) / float(12 * config.bins_per_note))


@functools.lru_cache(maxsize=4)
def gen_WF0(config: IMMConfig) -> tuple[np.ndarray, np.ndarray]:
    """(f0 grid [U], WF0 [F, U] column-max-normalized), read-only (kept per
    config: the full grid's 721 spectra take seconds)."""
    f0s = imm_f0s(config)
    cols = [klglott88_spectrum(f0, config.fs, config.w, config.Oq) for f0 in f0s]
    WF0 = np.stack(cols, axis=-1)
    WF0 = (WF0 / WF0.max(axis=0)[None, :]).astype(np.float32)
    f0s.flags.writeable = WF0.flags.writeable = False
    return f0s, WF0


def gen_WGAMMA(n_freq_bins: int, n_bases: int, overlap: float = 0.75) -> np.ndarray:
    """Overlapping Hann filterbank [F, P] (imm/wgamma.py:4-41)."""
    Ob = 1.0 - overlap
    n = int(np.ceil(1.0 / Ob))
    Ob = 1.0 / n
    O = 1.0 - Ob
    w = float(n_freq_bins) / ((n_bases - 1) * Ob + 1 - 2 * O)
    w = int(np.ceil(w))
    if w % 2 != 0:
        w -= 1
    centers = ((np.arange(n_bases) * Ob + (Ob - O) / 2.0) * w).astype(np.int64)
    WGAMMA = np.zeros((n_freq_bins, n_bases))
    hL = w // 2
    window = np.hanning(w)
    for p in range(n_bases):
        s = centers[p] - hL
        for hann_p in range(w):
            real_p = s + hann_p
            if 0 <= real_p < n_freq_bins:
                WGAMMA[real_p, p] = window[hann_p]
    return WGAMMA.astype(np.float32)


def _nmf_math(device):
    """float32 matmuls (no TF32) on a CUDA device (apps.common.float32_math;
    imported here, since apps.common imports the families, which import
    this module)."""
    from ..apps.common import float32_math

    return float32_math(device)


class IMM:
    """The NMF engine + melody chain. Stateless per track; the NMF is fitted
    per recording at inference (no learned weights)."""

    def __init__(self, config: IMMConfig = IMMConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.f0s, self.WF0 = gen_WF0(config)
        self.WGAMMA = gen_WGAMMA(config.F, config.P, 0.75)
        self.stft = SinebellSTFT(w=config.w, h=config.h, device=self.device)
        self.transition_matrix = imm_transition_matrix(
            bins_per_semitone=config.bins_per_note, n_bins=config.U
        )
        self._WF0 = torch.from_numpy(self.WF0.copy()).to(self.device)
        self._WGAMMA = torch.as_tensor(self.WGAMMA, device=self.device)

    def _t(self, x) -> torch.Tensor:
        """An array or tensor as float32 on the instance's device."""
        return torch.as_tensor(x, dtype=F32, device=self.device)

    # ------------------------------------------------------------------
    def _iteration(self, SX, HGAMMA, HPHI, HF0, WM, HM):
        """One multiplicative-update sweep (imm/tf_imm.py:243-321 order) on
        SX [F, N] -> ((HGAMMA, HPHI, HF0, WM, HM), (WPHI, SPHI, SF0, SV, SM,
        hatSX), IS divergence)."""
        eps = self.config.eps
        WGAMMA, WF0 = self._WGAMMA, self._WF0

        WPHI = WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SF0 = WF0 @ HF0
        SM = WM @ HM
        hatSX = SPHI * SF0 + SM

        # HF0
        PSX = WF0.T @ (SPHI * SX / (hatSX**2 + eps))
        QSX = WF0.T @ (SPHI / (hatSX + eps))
        HF0 = HF0 * PSX / (QSX + eps)
        SF0 = WF0 @ HF0
        SV = SPHI * SF0
        hatSX = SV + SM

        # HPHI (+ renorm into HF0)
        PSX = WPHI.T @ (SF0 * SX / (hatSX**2 + eps))
        QSX = WPHI.T @ (SF0 / (hatSX + eps))
        HPHI = HPHI * PSX / (QSX + eps)
        norm = HPHI.sum(dim=0)
        HPHI = HPHI / (norm + eps)[None, :]
        HF0 = HF0 * norm[None, :]
        SPHI = WPHI @ HPHI
        SF0 = WF0 @ HF0
        SV = SPHI * SF0
        hatSX = SV + SM

        # HM
        PSX = WM.T @ (SX / (hatSX**2 + eps))
        QSX = WM.T @ (1.0 / (hatSX + eps))
        HM = HM * PSX / (QSX + eps)
        SM = WM @ HM
        hatSX = SV + SM

        # HGAMMA (+ renorms into HPHI then HF0)
        PSX = WGAMMA.T @ (SF0 * SX / (hatSX**2 + eps)) @ HPHI.T
        QSX = WGAMMA.T @ (SF0 / (hatSX + eps)) @ HPHI.T
        HGAMMA = HGAMMA * PSX / (QSX + eps)
        norm = HGAMMA.sum(dim=0)
        HGAMMA = HGAMMA / (norm + eps)[None, :]
        HPHI = HPHI * norm[:, None]
        norm = HPHI.sum(dim=0)
        HPHI = HPHI / (norm + eps)[None, :]
        HF0 = HF0 * norm[None, :]
        WPHI = WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SF0 = WF0 @ HF0
        SV = SPHI * SF0
        hatSX = SV + SM

        # WM (+ renorm into HM)
        PSX = (SX / (hatSX**2 + eps)) @ HM.T
        QSX = (1.0 / (hatSX + eps)) @ HM.T
        WM = WM * PSX / (QSX + eps)
        norm = WM.sum(dim=0)
        WM = WM / (norm + eps)[None, :]
        HM = HM * norm[:, None]
        SM = WM @ HM
        hatSX = SV + SM

        err = self._is_divergence(SX, hatSX)
        return (HGAMMA, HPHI, HF0, WM, HM), (WPHI, SPHI, SF0, SV, SM, hatSX), err

    def _is_divergence(self, X, Y):
        """Itakura-Saito divergence, the mean over entries of
        (-log t + t) - 1 with t = (X + eps) / (Y + eps) (imm/tf_imm.py:330;
        the JAX fit's form: the sum over its real frames over their count)."""
        eps = self.config.eps
        t = (X + eps) / (Y + eps)
        return ((-torch.log(t) + t) - 1.0).sum() / (X.shape[0] * X.shape[1])

    def _keep_best_while(self, iterate_fn, state0):
        """The patience loop shared by the mono/stereo fits (the JAX
        package's lax.while_loop; the reference's host loop, imm/tf_imm.py:
        205-352 + the fit loops of imm/main_imm.py): strict `<` improvement,
        the first sweep always accepted, stop after `patient_iters`
        non-improving sweeps or `niters` in all. The best state is selected
        on the device (torch.where); the stop test reads one scalar a sweep.
        Returns (best state, its error, sweeps run)."""
        cfg = self.config
        dev = state0[0].device
        best, best_err = tuple(state0), torch.tensor(float("inf"), device=dev)
        since = torch.zeros((), dtype=torch.int32, device=dev)
        state, it = tuple(state0), 0
        while it < cfg.niters:
            state, err = iterate_fn(state)
            better = err < best_err if it else torch.ones((), dtype=torch.bool, device=dev)
            best = tuple(torch.where(better, n, b) for n, b in zip(state, best))
            best_err = torch.where(better, err, best_err)
            since = torch.where(better, torch.zeros_like(since), since + 1)
            it += 1
            if int(since) >= cfg.patient_iters:
                break
        return best, best_err, it

    def _aux_from_state(self, HGAMMA, HPHI, HF0, WM, HM):
        """The mono aux spectra as functions of the factors: the expressions
        the _iteration tail assembles (tests hold the two equal)."""
        WPHI = self._WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SF0 = self._WF0 @ HF0
        SM = WM @ HM
        SV = SPHI * SF0
        hatSX = SV + SM
        return WPHI, SPHI, SF0, SV, SM, hatSX

    def _draw(self, generator, shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator).abs()

    def fit(self, SX, seed: int = 0, generator: torch.Generator | None = None,
            init: dict | None = None) -> dict:
        """Run the NMF on a power spectrogram SX [N, F] (time-major, as the
        STFT returns). The initial factors HGAMMA [P, K], HPHI [K, N], HF0
        [U, N], WM [F, R], HM [R, N] are `init` (a dict of arrays), else
        |N(0, 1)| draws in that order from `generator` (a CPU generator;
        default: seeded with `seed`). Returns the best-IS-divergence factor
        dict with state-major [F, N]/[U, N] layouts like the reference,
        tensors on the instance's device, its `err` and the `sweeps` run."""
        cfg = self.config
        SX = self._t(SX).T  # [F, N]
        N = SX.shape[1]
        if init is None:
            g = generator if generator is not None else torch.Generator().manual_seed(seed)
            init = dict(HGAMMA=self._draw(g, (cfg.P, cfg.K)), HPHI=self._draw(g, (cfg.K, N)),
                        HF0=self._draw(g, (cfg.U, N)), WM=self._draw(g, (cfg.F, cfg.R)),
                        HM=self._draw(g, (cfg.R, N)))
        state0 = tuple(self._t(init[k]) for k in ("HGAMMA", "HPHI", "HF0", "WM", "HM"))

        def iterate(state):
            new_state, _, err = self._iteration(SX, *state)
            return new_state, err

        with _nmf_math(self.device):
            best, err, sweeps = self._keep_best_while(iterate, state0)
            WPHI, SPHI, SF0, SV, SM, hatSX = self._aux_from_state(*best)
        HGAMMA, HPHI, HF0, WM, HM = best
        return dict(
            HGAMMA=HGAMMA, HPHI=HPHI, HF0=HF0, WM=WM, HM=HM,
            WPHI=WPHI, SPHI=SPHI, SF0=SF0, SV=SV, SM=SM, hatSX=hatSX,
            err=float(err), sweeps=sweeps,
        )

    # ------------------------------------------------------------------
    def _stereo_iteration(self, SXL, SXR, HGAMMA, HPHI, HF0, WM, HM,
                          alphaL, alphaR, betaL, betaR):
        """One stereo sweep with per-channel gains (imm/tf_imm.py:354-618):
        updates HF0/HPHI/HM/HGAMMA/WM plus the channel gains alphaL/R and
        per-basis panning betaL/R (exponent-0.1 damped updates)."""
        eps = self.config.eps
        WGAMMA, WF0 = self._WGAMMA, self._WF0

        betaL2, betaR2 = betaL**2, betaR**2
        WPHI = WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SPHIL = alphaL**2 * SPHI
        SPHIR = alphaR**2 * SPHI
        SF0 = WF0 @ HF0
        SML = (WM * betaL2[None, :]) @ HM
        SMR = (WM * betaR2[None, :]) @ HM
        hatSXL = SPHIL * SF0 + SML
        hatSXR = SPHIR * SF0 + SMR

        # HF0
        PSX = WF0.T @ (
            SPHIL * SXL / (hatSXL**2 + eps) + SPHIR * SXR / (hatSXR**2 + eps)
        )
        QSX = WF0.T @ (SPHIL / (hatSXL + eps) + SPHIR / (hatSXR + eps))
        HF0 = HF0 * PSX / (QSX + eps)
        SF0 = WF0 @ HF0
        SF0L, SF0R = alphaL**2 * SF0, alphaR**2 * SF0
        hatSXL = SPHI * SF0L + SML
        hatSXR = SPHI * SF0R + SMR

        # HPHI
        PSX = WPHI.T @ (
            SF0L * SXL / (hatSXL**2 + eps) + SF0R * SXR / (hatSXR**2 + eps)
        )
        QSX = WPHI.T @ (SF0L / (hatSXL + eps) + SF0R / (hatSXR + eps))
        HPHI = HPHI * PSX / (QSX + eps)
        norm = HPHI.sum(dim=0)
        HPHI = HPHI / (norm + eps)[None, :]
        HF0 = HF0 * norm[None, :]
        SPHI = WPHI @ HPHI
        SF0 = WF0 @ HF0
        SF0L, SF0R = alphaL**2 * SF0, alphaR**2 * SF0
        SVL, SVR = SPHI * SF0L, SPHI * SF0R
        hatSXL, hatSXR = SVL + SML, SVR + SMR

        # HM
        WML = WM * betaL2[None, :]
        WMR = WM * betaR2[None, :]
        PSX = WML.T @ (SXL / (hatSXL**2 + eps)) + WMR.T @ (SXR / (hatSXR**2 + eps))
        QSX = WML.T @ (1.0 / (hatSXL + eps)) + WMR.T @ (1.0 / (hatSXR + eps))
        HM = HM * PSX / (QSX + eps)
        SML = WM @ (betaL2[:, None] * HM)
        SMR = WM @ (betaR2[:, None] * HM)
        hatSXL, hatSXR = SVL + SML, SVR + SMR

        # HGAMMA
        PSX = WGAMMA.T @ (
            SF0L * SXL / (hatSXL**2 + eps) + SF0R * SXR / (hatSXR**2 + eps)
        ) @ HPHI.T
        QSX = WGAMMA.T @ (
            SF0L / (hatSXL + eps) + SF0R / (hatSXR + eps)
        ) @ HPHI.T
        HGAMMA = HGAMMA * PSX / (QSX + eps)
        norm = HGAMMA.sum(dim=0)
        HGAMMA = HGAMMA / (norm + eps)[None, :]
        HPHI = HPHI * norm[:, None]
        norm = HPHI.sum(dim=0)
        HPHI = HPHI / (norm + eps)[None, :]
        HF0 = HF0 * norm[None, :]
        WPHI = WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SF0 = WF0 @ HF0
        SV = SPHI * SF0
        SVL, SVR = alphaL**2 * SV, alphaR**2 * SV
        hatSXL, hatSXR = SVL + SML, SVR + SMR

        # WM
        HML = betaL2[:, None] * HM
        HMR = betaR2[:, None] * HM
        PSX = (SXL / (hatSXL**2 + eps)) @ HML.T + (SXR / (hatSXR**2 + eps)) @ HMR.T
        QSX = (1.0 / (hatSXL + eps)) @ HML.T + (1.0 / (hatSXR + eps)) @ HMR.T
        WM = WM * PSX / (QSX + eps)
        norm = WM.sum(dim=0)
        WM = WM / (norm + eps)[None, :]
        HM = HM * norm[:, None]
        SML = (WM * betaL2[None, :]) @ HM
        SMR = (WM * betaR2[None, :]) @ HM
        hatSXL, hatSXR = SVL + SML, SVR + SMR

        # alpha (damped multiplicative update, exponent 0.1)
        PL = (SV * SXL / (hatSXL**2 + eps)).sum()
        QL = (SV / (hatSXL + eps)).sum()
        alphaL = alphaL * (PL / (QL + eps)) ** 0.1
        PR = (SV * SXR / (hatSXR**2 + eps)).sum()
        QR = (SV / (hatSXR + eps)).sum()
        alphaR = alphaR * (PR / (QR + eps)) ** 0.1
        alphaL, alphaR = alphaL + eps, alphaR + eps
        alphaL = alphaL / (alphaL + alphaR)
        alphaR = 1.0 - alphaL
        hatSXL = alphaL**2 * SV + SML
        hatSXR = alphaR**2 * SV + SMR

        # beta
        PL = ((WM.T @ (SXL / (hatSXL**2 + eps))) * HM).sum(dim=1)
        QL = ((WM.T @ (1.0 / (hatSXL + eps))) * HM).sum(dim=1)
        betaL = betaL * (PL / (QL + eps)) ** 0.1
        PR = ((WM.T @ (SXR / (hatSXR**2 + eps))) * HM).sum(dim=1)
        QR = ((WM.T @ (1.0 / (hatSXR + eps))) * HM).sum(dim=1)
        betaR = betaR * (PR / (QR + eps)) ** 0.1
        betaL, betaR = betaL + eps, betaR + eps
        betaL = betaL / (betaL + betaR)
        betaR = 1.0 - betaL
        betaL2, betaR2 = betaL**2, betaR**2

        SPHIL, SPHIR = alphaL**2 * SPHI, alphaR**2 * SPHI
        SVL, SVR = SPHIL * SF0, SPHIR * SF0
        SML = (WM * betaL2[None, :]) @ HM
        SMR = (WM * betaR2[None, :]) @ HM
        hatSXL, hatSXR = SVL + SML, SVR + SMR

        err = 0.5 * (self._is_divergence(SXL, hatSXL) + self._is_divergence(SXR, hatSXR))
        state = (HGAMMA, HPHI, HF0, WM, HM, alphaL, alphaR, betaL, betaR)
        aux = (SVL, SVR, SML, SMR, hatSXL, hatSXR)
        return state, aux, err

    def _stereo_aux_from_state(self, HGAMMA, HPHI, HF0, WM, HM, alphaL, alphaR, betaL, betaR):
        """The stereo aux spectra as functions of the factors: the
        expressions the _stereo_iteration tail assembles (tests hold the two
        equal)."""
        WPHI = self._WGAMMA @ HGAMMA
        SPHI = WPHI @ HPHI
        SF0 = self._WF0 @ HF0
        betaL2, betaR2 = betaL**2, betaR**2
        SVL = (alphaL**2 * SPHI) * SF0
        SVR = (alphaR**2 * SPHI) * SF0
        SML = (WM * betaL2[None, :]) @ HM
        SMR = (WM * betaR2[None, :]) @ HM
        return SVL, SVR, SML, SMR, SVL + SML, SVR + SMR

    def fit_stereo(self, SXL, SXR, sHF0, seed: int = 0,
                   generator: torch.Generator | None = None, init: dict | None = None) -> dict:
        """Second (stereo) pass with the melody-constrained sHF0 init: power
        spectrograms SXL/SXR [N, F] -> separation factors with per-channel
        gains (imm/tf_imm.py:354-618). The initial factors HGAMMA [P, K],
        HPHI [K, N], WM [F, R], HM [R, N] and u [R] are `init`, else
        |N(0, 1)| draws, then a U[0, 1) draw for u, in that order from
        `generator` (a CPU generator; default: seeded with `seed`). As in
        the reference, betaL = u and betaR = 1 - u come from ONE draw; the
        gains start at 0.5."""
        cfg = self.config
        SXL, SXR = self._t(SXL).T, self._t(SXR).T
        N = SXL.shape[1]
        if init is None:
            g = generator if generator is not None else torch.Generator().manual_seed(seed)
            init = dict(HGAMMA=self._draw(g, (cfg.P, cfg.K)), HPHI=self._draw(g, (cfg.K, N)),
                        WM=self._draw(g, (cfg.F, cfg.R)), HM=self._draw(g, (cfg.R, N)),
                        u=torch.rand((cfg.R,), generator=g))
        u = self._t(init["u"])
        half = torch.tensor(0.5, dtype=F32, device=self.device)
        state0 = (self._t(init["HGAMMA"]), self._t(init["HPHI"]), self._t(sHF0),
                  self._t(init["WM"]), self._t(init["HM"]), half, half.clone(), u, 1.0 - u)

        def iterate(state):
            new_state, _, err = self._stereo_iteration(SXL, SXR, *state)
            return new_state, err

        with _nmf_math(self.device):
            best, err, sweeps = self._keep_best_while(iterate, state0)
            SVL, SVR, SML, SMR, hatSXL, hatSXR = self._stereo_aux_from_state(*best)
        HGAMMA, HPHI, HF0, WM, HM, aL, aR, bL, bR = best
        return dict(
            HGAMMA=HGAMMA, HPHI=HPHI, HF0=HF0, WM=WM, HM=HM,
            alphaL=aL, alphaR=aR, betaL=bL, betaR=bR,
            SVL=SVL, SVR=SVR, SML=SML, SMR=SMR, hatSXL=hatSXL, hatSXR=hatSXR,
            err=float(err), sweeps=sweeps,
        )

    def separate_stereo(self, XL, XR, stereo_result: dict):
        """Wiener-mask separation + ISTFT resynthesis: complex spectra
        XL/XR [N, F] -> dict(melody=(yL, yR), accompaniment=(yL, yR)),
        float32 NumPy."""
        eps = self.config.eps

        def mask_istft(X, S, hatS):
            mask = ((S + eps) / (hatS + eps)).T  # [N, F]
            X = torch.as_tensor(X, device=self.device)
            return self.stft.istft(X * mask).cpu().numpy()

        r = stereo_result
        return dict(
            melody=(mask_istft(XL, r["SVL"], r["hatSXL"]), mask_istft(XR, r["SVR"], r["hatSXR"])),
            accompaniment=(mask_istft(XL, r["SML"], r["hatSXL"]),
                           mask_istft(XR, r["SMR"], r["hatSXR"])),
        )

    def constrained_HF0(self, HF0, melody_states: np.ndarray) -> np.ndarray:
        """Melody-constrained sHF0: keep only bins within half a semitone of
        the decoded state per voiced frame (imm/tf_imm.py:720-739)."""
        cfg = self.config
        U = cfg.U
        HF0 = _numpy(HF0)
        states = np.asarray(melody_states)
        voiced = states < U
        offset = cfg.bins_per_note // 2
        start = np.maximum(states - offset, 0)
        end = np.minimum(states + offset + 1, U)
        bins = np.arange(U)[:, None]
        mask = (bins >= start[None, :]) & (bins < end[None, :]) & voiced[None, :]
        return np.where(mask, HF0, 0.0).astype(np.float32)

    def energies_for_f0s(self, result: dict, SX) -> np.ndarray:
        """Per-f0-bin Wiener energies [U, N], two matmuls:
        E[u,n] = HF0[u,n]^2 * sum_f WF0[f,u]^2 * (SPHI[f,n]/hatSX[f,n])^2 * SX[f,n]."""
        SX = self._t(SX).T  # [F, N]
        with _nmf_math(self.device):
            G = (result["SPHI"] / (result["hatSX"] + self.config.eps)) ** 2 * SX  # [F, N]
            E = ((self._WF0**2).T @ G) * result["HF0"] ** 2
        return E.cpu().numpy()

    def logits_from_fit(self, result: dict, SX) -> np.ndarray:
        """Fit + power spectrogram -> log10 Wiener energies + 6, [U, N]
        (the tail of imm/tf_imm.py:659-678)."""
        energies = self.energies_for_f0s(result, SX)
        hw = (self.config.w // 2) ** 2
        energies = np.maximum(energies / float(hw), 1e-11)
        return (np.log10(energies) + 6.0).astype(np.float32)

    def power_spectrogram(self, samples) -> torch.Tensor:
        """samples -> |sinebell STFT|^2 [N, F] on the instance's device."""
        return self.stft.stft(samples).abs() ** 2

    def logits(self, samples: np.ndarray, seed: int = 0) -> np.ndarray:
        """Full per-track chain: samples -> log10 Wiener energies + 6,
        [U, N] (imm/tf_imm.py:659-678)."""
        SX = self.power_spectrogram(samples)
        return self.logits_from_fit(self.fit(SX, seed=seed), SX)

    def process_HF0(self, HF0) -> np.ndarray:
        """HF0 -> log observations for the "original" decode: floor at the
        smallest positive value (min exp(-87)), log, pad an unvoiced row at
        the running minimum (imm/tf_imm.py:71-88)."""
        HF0 = _numpy(HF0)
        t = HF0[HF0 > 0].min()
        if np.log(t) < -87:
            t = np.exp(-87)
        logH = np.log(HF0 + t)
        return np.pad(logH, [(0, 1), (0, 0)], mode="constant", constant_values=logH.min())

    def voicing_detection(self, SX, result: dict, melody_states: np.ndarray) -> np.ndarray:
        """Melody-band Wiener energy voicing with the cumulative-energy
        threshold 5.84e-4 (imm/tf_imm.py:705-756)."""
        cfg = self.config
        sHF0 = self.constrained_HF0(result["HF0"], melody_states)
        with _nmf_math(self.device):
            SF0 = self._WF0 @ self._t(sHF0)
            SV = result["SPHI"] * SF0
            hatSX = SV + result["SM"]
            ratio = (SV + cfg.eps) / (hatSX + cfg.eps)
            frame_energies = (ratio**2 * self._t(SX).T).sum(dim=0).cpu().numpy()
        es = np.sort(frame_energies)
        c = np.cumsum(es)
        c = c / c[-1]
        idx = int(np.argmax(c > 5.84e-4))
        return frame_energies > es[idx]

    def melody_f0s(self, melody_states: np.ndarray, voicing: np.ndarray) -> np.ndarray:
        states = np.minimum(np.asarray(melody_states), self.config.U - 1)
        return np.where(voicing, self.f0s[states], 0.0)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
