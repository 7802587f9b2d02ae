"""Invertible Non-Stationary Gabor Transform (NSGT) in PyTorch (counterpart of
viterbi_spl_tpu/frontend/nsgt.py).

A CQT-like invertible transform with 60 bins/oct from fmin = midi 24 /
factor^2, minimum bandwidth gamma = 14 Hz, hop 64 at 44.1 kHz; windows are
raised-cosine flanks with the canonical dual computed from the
painless-frame diagonal (dcnet/nsgt.py:225-259).

The window and index tables are built in NumPy exactly as the JAX package
builds them: for every (band, output-position) pair the source rFFT bin, a
conjugation sign and the window weight, so that the forward is

    rfft -> dense gather [n_bands, max_bw] -> weight multiply -> batched ifft

and the inverse a batched fft -> flat gather -> weighted index_add_ ->
irfft, on the device the instance was made for (CUDA unless the caller
asks for the CPU). Both compute in float64 (complex128; the JAX package's
in complex64) and return float32 signals: in complex64 the card's cuFFT
and the CPU's FFT put dcnet's feature 1.7e-4 of its [0, 1] range apart on
a 20 s synthetic track (chip_smoke.py phase 3f on an H100), the bins near
the feature's -120 dB floor being where float32 rounding is a large
relative error. In float64 the port is the JAX package's chain less the
latter's float32 error (5.3e-5 at most on a 2.5 x 2^17-sample track,
against a float64 forward).

Long audio uses the reference's overlap-save blocking: power-of-two Ls
blocks with `uni_side_cyc_frames = int(2.88/gamma * sr/hop)` cyclic
boundary frames computed redundantly and trimmed (dcnet/nsgt.py:420-505),
one forward a block: a block's coefficients are one [n_bands, max_bw]
batched ifft already (149 MB at Ls = 2^21), and a batch of blocks would
change the CPU's rfft code path and so its last bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..metrics.mel_eval import midi_to_hz
from ..utils import resolve_device


def _rc01(n: int) -> np.ndarray:
    """Raised-cosine ramp on [0, 1): rc[0] = 0, rc[-1] < 1 (dcnet/nsgt.py:16-24)."""
    return 0.5 - 0.5 * np.cos(np.pi * np.arange(n) / float(n))


class NSGT:
    B = 60
    SR = 44100
    GAMMA = 14.0
    HOP = 64

    def __init__(self, Ls: int, device=None):
        if Ls & (Ls - 1):
            raise ValueError("Ls must be a power of two")
        self.Ls = Ls
        self.hLs = Ls // 2
        self.device = resolve_device(device)
        self.factor = 2.0 ** (1.0 / self.B)
        self.fmin = float(midi_to_hz(np.array([24.0]))[0]) / self.factor**2
        self.num_frames_per_Ls = Ls // self.HOP
        self.uni_side_cyc_frames = int(2.88 / self.GAMMA * self.SR / self.HOP)
        self._build_windows()
        self._build_tables()
        to = functools.partial(torch.as_tensor, device=self.device)
        f64 = functools.partial(torch.as_tensor, device=self.device, dtype=torch.float64)
        self._fwd = (to(self._fwd_src.astype(np.int64)), f64(self._fwd_sign), f64(self._fwd_w))
        self._inv = (to(self._inv_gather.astype(np.int64)), to(self._inv_scatter.astype(np.int64)),
                     f64(self._inv_w))

    # ------------------------------------------------------------------
    def _build_windows(self):
        Ls, hLs = self.Ls, self.hLs
        nf = self.SR // 2

        fbas = []
        f = self.fmin
        while f < nf:
            fbas.append(f)
            f *= self.factor
        fbas = np.asarray(fbas)
        self.Lfbas = Lfbas = len(fbas)
        self.nyq_pos = nyq_pos = Lfbas + 1

        fft_res = self.SR / float(Ls)
        posit = np.round(fbas / fft_res).astype(np.int64)
        posit = np.concatenate([[0], posit, [hLs]])
        posit = np.pad(posit, (0, Lfbas), mode="reflect")
        posit[nyq_pos + 1 :] = Ls - posit[nyq_pos + 1 :]
        assert posit[0] == 0 and posit[nyq_pos] == hLs

        min_bw = int(self.GAMMA / 2.0 / fft_res)
        min_bw = 2 * min_bw + 1

        bw = np.empty(Lfbas + 2, np.int64)
        ranges: list[np.ndarray] = []
        for idx in range(Lfbas + 2):
            if idx == 0:
                bw[idx] = 2 * posit[1] + 1
                ranges.append(np.arange(-posit[1], posit[1] + 1))
            elif idx == 1:
                bw[idx] = min_bw
                t = min_bw // 2
                ranges.append(np.arange(-t, t + 1))
            else:
                _bw = posit[idx + 1] - posit[idx - 1] + 1
                if _bw <= min_bw:
                    bw[idx] = bw[1]
                    ranges.append(ranges[1])
                else:
                    bw[idx] = _bw
                    llen = posit[idx - 1] - posit[idx]
                    rlen = posit[idx + 1] - posit[idx]
                    ranges.append(np.arange(llen, rlen + 1))

        bw = np.pad(bw, (0, Lfbas), mode="reflect")

        # raised-cosine windows (flat-top DC window)
        gs: list[np.ndarray] = []
        r1 = ranges[1]
        llen1 = -r1[0]
        left1 = _rc01(llen1)
        g1 = np.concatenate([left1, [1.0], left1[::-1]])
        g0 = np.ones(bw[0])
        g0[:llen1] = left1
        g0[-llen1:] = left1[::-1]
        gs.extend([g0, g1])
        for idx in range(2, nyq_pos + 1):
            if bw[idx] == bw[1]:
                gs.append(gs[1])
                continue
            r = ranges[idx]
            left = _rc01(-r[0])
            right = _rc01(r[-1])[::-1]
            gs.append(np.concatenate([left, [1.0], right]))

        # mirror for negative-frequency windows
        for g, r in zip(gs[-2 : -len(gs) : -1], ranges[-2 : -len(ranges) : -1]):
            gs.append(g[::-1])
            ranges.append(-r[::-1])
        assert len(gs) == len(ranges) == 2 * Lfbas + 2

        win_range_list = [(posit[ii] + ranges[ii]) % Ls for ii in range(2 * Lfbas + 2)]

        max_bw = int(2 ** np.ceil(np.log2(bw.max())))
        assert Ls // max_bw == self.HOP, "hop/band-size invariant violated"
        norm = 2.0 * max_bw / Ls
        gs = [g * norm for g in gs]

        # painless-frame diagonal + canonical dual windows
        diagonal = np.zeros(Ls)
        for ii in range(2 * Lfbas + 2):
            diagonal[win_range_list[ii]] += gs[ii] ** 2
        assert np.all(diagonal > 0.0), "frame is not invertible"
        diagonal = np.pad(diagonal[: self.hLs + 1], (0, self.hLs - 1), mode="reflect")
        gds = [gs[ii] / diagonal[win_range_list[ii]] for ii in range(2 * Lfbas + 2)]

        self.posit, self.bw, self.max_bw = posit, bw, max_bw
        self.ranges, self.gs, self.gds = ranges, gs, gds
        self.win_range_list = win_range_list
        self.n_out_bands = Lfbas + 2  # DC .. Nyquist (forward output rows)

    def _build_tables(self):
        """Dense forward/inverse index tables (see module docstring)."""
        Ls, hLs, max_bw = self.Ls, self.hLs, self.max_bw
        nb = self.n_out_bands

        fwd_src = np.zeros((nb, max_bw), np.int32)  # rFFT bin index
        fwd_sign = np.zeros((nb, max_bw), np.float32)  # conj sign for imag
        fwd_w = np.zeros((nb, max_bw), np.float32)  # window weight

        for ii in range(nb):
            g = self.gs[ii]
            lg = len(g)
            win_range = self.win_range_list[ii]
            llen = -self.ranges[ii][0]
            displace = int(self.posit[ii] % max_bw - llen)
            p = (np.arange(lg) + displace) % max_bw  # destination positions
            src = win_range.astype(np.int64)
            conj = src > hLs
            src_rfft = np.where(conj, Ls - src, src)
            fwd_src[ii, p] = src_rfft
            fwd_sign[ii, p] = np.where(conj, -1.0, 1.0)
            fwd_w[ii, p] = g

        # inverse: flat (band, j) entries
        inv_gather, inv_scatter, inv_w = [], [], []
        for ii in range(nb):
            gd = self.gds[ii]
            r = self.ranges[ii]
            displace0 = int(self.posit[ii] % max_bw)
            src_pos = (r + displace0) % max_bw
            inv_gather.append(ii * max_bw + src_pos)
            inv_scatter.append(self.win_range_list[ii])
            inv_w.append(gd)
        self._inv_gather = np.concatenate(inv_gather).astype(np.int32)
        self._inv_scatter = np.concatenate(inv_scatter).astype(np.int32)
        self._inv_w = np.concatenate(inv_w).astype(np.float32)
        self._fwd_src, self._fwd_sign, self._fwd_w = fwd_src, fwd_sign, fwd_w

    # ------------------------------------------------------------------
    def forward(self, samples) -> torch.Tensor:
        """[Ls] float32 -> [n_out_bands, max_bw] complex128 coefficients, on
        the instance's device."""
        x = torch.as_tensor(np.asarray(samples, np.float32), device=self.device).double()
        if x.shape != (self.Ls,):
            raise ValueError(f"expected [{self.Ls}] samples, got {tuple(x.shape)}")
        src, sign, w = self._fwd
        spec = torch.fft.rfft(x)  # [hLs + 1]
        f = torch.complex(spec.real[src] * w, spec.imag[src] * sign * w)
        return torch.fft.ifft(f, dim=1)

    def inverse(self, coeffs) -> torch.Tensor:
        """[n_out_bands, max_bw] complex coefficients -> [Ls] float32."""
        Ls, hLs = self.Ls, self.hLs
        c128 = torch.complex128
        gather, scatter, w = self._inv
        c = torch.as_tensor(coeffs, device=self.device).to(c128)
        F = torch.fft.fft(c, dim=1).reshape(-1)
        vals = F[gather] * w
        spec = torch.zeros(Ls, dtype=c128, device=self.device).index_add_(0, scatter, vals)
        half = torch.cat([spec[0:1].real.to(c128), spec[1:hLs], spec[hLs : hLs + 1].real.to(c128)])
        return torch.fft.irfft(half, n=Ls).to(torch.float32)

    # ------------------------------------------------------------------
    def track_blocks(self, samples: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]], int]:
        """The overlap-save blocking of a track (dcnet/nsgt.py:420-505):
        (blocks [n_blocks, Ls] float32, per block the (first, count) of the
        magnitude frames it keeps, frames of the track). A track shorter
        than one block's payload is one zero-padded block, no seams (the
        reference picks Ls per track and never meets that case, but a
        serving user may transcribe a clip shorter than 2^17 samples)."""
        hop = self.HOP
        cyc = self.uni_side_cyc_frames
        payload = self.num_frames_per_Ls - 2 * cyc

        samples = np.asarray(samples, np.float32)
        n = len(samples)
        r = n % hop
        if r:
            samples = np.pad(samples, (0, hop - r))
            n = len(samples)
        frames_before = n // hop
        n_snippets = -(-frames_before // payload)
        if n_snippets < 2:
            return np.pad(samples, (0, self.Ls - n))[None], [(0, frames_before)], frames_before
        r = (frames_before - payload) % (n_snippets - 1)
        if r:
            samples = np.pad(samples, (0, (n_snippets - 1 - r) * hop))
        frames_after = len(samples) // hop
        hop_frames = (frames_after - payload) // (n_snippets - 1)

        blocks, keep = [], []
        for k in range(n_snippets):
            start = k * hop_frames - cyc
            end = k * hop_frames + payload + cyc
            pre = max(0, -start) * hop
            post = max(0, end - frames_after) * hop
            seg = samples[max(0, start) * hop : min(end, frames_after) * hop]
            seg = np.pad(seg, (pre, post))
            assert len(seg) == self.Ls
            blocks.append(seg)
            keep.append((cyc, hop_frames if k < n_snippets - 1 else payload))
        return np.stack(blocks), keep, frames_before

    def transform_track(self, samples: np.ndarray) -> np.ndarray:
        """Whole-track magnitude NSGT [num_frames, Lfbas+2] float32 (NumPy)
        via overlap-save blocking with cyclic boundary frames."""
        blocks, keep, frames = self.track_blocks(samples)
        out = torch.cat([self.forward(b).abs()[:, a : a + n].to(torch.float32)
                         for b, (a, n) in zip(blocks, keep)], dim=1)
        return np.require(out[:, :frames].T.cpu().numpy(), np.float32, requirements=["C"])


@functools.lru_cache(maxsize=8)
def _nsgt(Ls: int, device: torch.device) -> NSGT:
    return NSGT(Ls, device=device)


def nsgt_for_length(num_samples: int, lses=(2**17, 2**18, 2**19, 2**20, 2**21, 2**22),
                    device=None) -> NSGT:
    """Pick the NSGT instance whose Ls matches a track length, as the
    reference's per-track instance selection does
    (dcnet/softmax_viterbi.py:411-416 + searchsorted in gen_spec_fn). One
    instance, with its device tables, is kept per (Ls, device)."""
    lses = np.asarray(lses)
    t = int(np.searchsorted(lses, num_samples))
    if t < 1:
        t = 1
    return _nsgt(int(lses[t - 1]), resolve_device(device))


def dcnet_feature(nsgt_mag: np.ndarray) -> np.ndarray:
    """NSGT magnitudes -> dcnet input: [:, ::4, bins 1..500] (hop 256, 500
    bins), amplitude_to_db(ref=max, top_db=120)/120 + 1
    (dcnet/softmax_viterbi.py:437-471). float64 NumPy, as in the JAX
    package."""
    x = nsgt_mag[::4, 1:501].astype(np.float64)
    amin = 1e-5  # librosa amplitude amin sqrt(1e-10)
    mag = np.maximum(x, amin)
    ref = max(float(mag.max()), amin)
    db = 20.0 * np.log10(mag) - 20.0 * np.log10(ref)
    db = np.maximum(db, db.max() - 120.0)
    return (db / 120.0 + 1.0).astype(np.float32)
