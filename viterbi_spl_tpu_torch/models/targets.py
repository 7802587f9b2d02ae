"""Label smoothing + training losses shared by the model families
(counterpart of viterbi_spl_tpu/models/targets.py), and the families' note
grids, which families.py imports from here.

The reference trains every family against Gaussian-blurred note targets
(sigma in semitones, cutoff 4e-3) on its pitch-bin grid:

- dcnet: per-bin sigmoid BCE, no non-melody class, notes clipped to
  note_range[-1]+0.4 (dcnet/softmax_viterbi.py:375-406).
- msnet/ftanet: 321-class softmax CE with a prepended non-melody class at
  note 0, blurred targets normalized to sum 1
  (msnet/hsieh_m2m3.py:342-377, ftanet/yu.py:280-316).
- jdc: 722-class softmax CE (sigma = 0.9/16 on a 1/16-semitone grid, voiced
  notes clamped into [38-2/16, 83+2/16]) + 0.5 * voicing BCE
  (jdc/kum_m2m3.py:289-341); the l2 regularizer is applied by the trainer.

Note grids:
- dcnet: 23.6 + arange(320)/5 (NSGT bins; fmin = midi 24 / factor^2 = midi
  23.6, dcnet/nsgt.py:73),
- msnet/ftanet: hz_to_midi(cfp central_freqs[1:]) = midi(31 Hz) + (k+1)/5
  (msnet/hsieh_m2m3.py:185-203),
- tonet: hz_to_midi(tonet cfp central_freqs[1:]), 360 bins from 32 Hz,
- jdc: 38 + arange(721)/16 (jdc/kum_m2m3.py:310-312).

The losses take tensors on any device and return a 0-d tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..frontend.cfp import MSNET_CFP, TONET_CFP
from ..metrics.mel_eval import hz_to_midi

CUTOFF_PROB = 4e-3


def note_grid(note_min: float, n_bins: int, bins_per_semitone: float) -> np.ndarray:
    return (note_min + np.arange(n_bins) / bins_per_semitone).astype(np.float32)


def cfp_note_range(central_freqs: np.ndarray) -> np.ndarray:
    """hz_to_midi of central_freqs[1:] (msnet/hsieh_m2m3.py:185-203)."""
    return hz_to_midi(np.asarray(central_freqs)[1:]).astype(np.float32)


def _msnet_note_range() -> np.ndarray:
    return cfp_note_range(MSNET_CFP.central_freqs)


def _tonet_note_range() -> np.ndarray:
    return cfp_note_range(TONET_CFP.central_freqs)


DCNET_NOTE_RANGE = note_grid(23.6, 320, 5)
JDC_NOTE_RANGE = note_grid(38.0, 721, 16)


def _grid(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=like.device)


def gaussian_blur_targets(ref_notes, note_range, sigma, normalize: bool):
    """[T] MIDI notes -> [T, len(note_range)] blurred targets.

    exp(-(note - center)^2 / (2 sigma^2)), zeroed below CUTOFF_PROB, and
    (softmax families) normalized to sum 1 per frame. Callers clip/clamp the
    notes and prepend the non-melody grid entry as appropriate.
    """
    d = ref_notes[:, None] - note_range[None, :]
    t = torch.exp(-(d**2) / (2.0 * sigma**2))
    t = torch.where(t < CUTOFF_PROB, 0.0, t)
    if normalize:
        t = t / torch.sum(t, dim=-1, keepdim=True)
    return t


def dcnet_loss(ref_notes, logits):
    """Per-bin BCE vs blurred targets (no non-melody class)."""
    note_range = _grid(DCNET_NOTE_RANGE, logits)
    ref_notes = torch.minimum(ref_notes.reshape(-1), note_range[-1] + 0.4)
    logits = logits.reshape(-1, note_range.shape[0])
    targets = gaussian_blur_targets(ref_notes, note_range, 0.18, normalize=False)
    return torch.mean(_bce_with_logits(targets, logits))


def softmax_smoothed_loss(ref_notes, logits):
    """(n_bins+1)-class softmax CE with non-melody class 0 at note 0
    (msnet/ftanet; logits [T, 321] or [..., n_bins+1])."""
    note_range = _grid(np.pad(_msnet_note_range(), (1, 0)), logits)
    ref_notes = torch.minimum(ref_notes, note_range[-1] + 0.4)
    targets = gaussian_blur_targets(ref_notes.reshape(-1), note_range, 0.18, normalize=True)
    logits = logits.reshape(-1, note_range.shape[0])
    loss = -torch.sum(targets * F.log_softmax(logits, dim=-1), dim=-1)
    return torch.mean(loss)


def tonet_labels(ref_notes):
    """MIDI notes [B, T] -> integer label dict(pitch [0..360], chroma
    [0..12], octave [0..6]) per tonet/main_shaun.py:317-363.

    pitch = index of the first grid note >= ref note (0 = unvoiced);
    octave = (pitch-1)//60 + 1; chroma = (pitch-1)%60//5 + 1; both 0 when
    unvoiced."""
    note_range = _grid(_tonet_note_range(), ref_notes)
    note_min, note_max = note_range[0], note_range[-1]
    positive = ref_notes > 0.0
    notes = torch.where(positive & (ref_notes < note_min), note_min, ref_notes)
    notes = torch.where(notes > note_max, note_max, notes)
    grid = torch.cat([torch.zeros(1, device=note_range.device), note_range])
    ge = (grid[None, None, :] - notes[..., None]) >= 0.0
    # the first True (argmax of a bool picks the first maximum)
    pitch = torch.argmax(ge.to(torch.uint8), dim=-1).to(torch.int32)
    octave = torch.where(positive, torch.div(pitch - 1, 60, rounding_mode="floor") + 1, 0)
    chroma = torch.where(positive, torch.div((pitch - 1) % 60, 5, rounding_mode="floor") + 1, 0)
    return dict(pitch=pitch, chroma=chroma.to(torch.int32), octave=octave.to(torch.int32))


def tonet_loss(ref_notes, logits):
    """Mean of 3 cross-entropies on integer pitch/chroma/octave labels
    (tonet/main_shaun.py:298-315). logits: dict of [B, C, T] tensors;
    chroma/octave may be None (the tcfp/single TONet ablations train on
    the pitch CE alone, tonet/model/tonet.py:278-300)."""
    labels = tonet_labels(ref_notes)

    def ce(lg, lb):
        lg = lg.transpose(1, 2)  # [B, T, C]
        return -torch.gather(F.log_softmax(lg, dim=-1), -1, lb[..., None].long())[..., 0]

    losses = [
        ce(logits[k], labels[k])
        for k in ("pitch", "chroma", "octave")
        if logits.get(k) is not None
    ]
    return torch.mean(torch.stack(losses, dim=-1))


def jdc_loss(ref_notes, pitch_logits, voicing_logits):
    """722-class pitch CE + 0.5 * voicing BCE (jdc/kum_m2m3.py:289-341)."""
    note_range = _grid(np.pad(JDC_NOTE_RANGE, (1, 0)), pitch_logits)
    ref_notes = ref_notes.reshape(-1)
    pitch_logits = pitch_logits.reshape(-1, 722)
    voicing_logits = voicing_logits.reshape(-1)
    ref_voicing = ref_notes > 0.1

    note_min = float(np.float32(38.0 - 2.0 / 16.0))
    note_max = float(np.float32(83.0 + 2.0 / 16.0))
    notes = torch.where((ref_notes > 0.1) & (ref_notes < note_min),
                        torch.tensor(note_min, device=ref_notes.device), ref_notes)
    notes = torch.clamp(notes, max=note_max)

    targets = gaussian_blur_targets(notes, note_range, 0.9 / 16.0, normalize=True)
    pitch_loss = torch.mean(
        -torch.sum(targets * F.log_softmax(pitch_logits, dim=-1), dim=-1)
    )
    voicing_loss = torch.mean(_bce_with_logits(ref_voicing.to(torch.float32), voicing_logits))
    return pitch_loss + 0.5 * voicing_loss


def _bce_with_logits(labels, logits):
    """tf.nn.sigmoid_cross_entropy_with_logits semantics:
    max(x,0) - x*z + log1p(exp(-|x|))."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
