"""Self-contained melody-evaluation semantics (mir_eval.melody-equivalent).

The reference cross-checks every accumulated metric against
mir_eval.melody.evaluate per track (dcnet/softmax_viterbi.py:3160-3198) and
uses mir_eval.melody.resample_melody_series to move 256-hop labels to a
10 ms grid (jdc/kum_m2m3.py:389-421). mir_eval is not available in this
environment, so this module reimplements those exact semantics:

- negative-frequency voicing convention (est freq < 0 => unvoiced estimate
  whose magnitude still scores raw pitch accuracy),
- cents relative to a 10 Hz base,
- zero-order-hold voicing resampling + linear pitch resampling with
  held-through-zeros frequencies; when the target timebase extends past the
  source, mir_eval appends one terminal (freq=0, unvoiced) sample at the
  new end time rather than holding the edge,
- STRICT 50-cent tolerance (`< cent_tolerance`, mir_eval>=0.6 semantics —
  also what the reference's own accumulators use, diffs < 0.5 semitones at
  dcnet/softmax_viterbi.py:1771) with the nonzero-cent mask
  (`est_cent != 0 and ref_cent != 0`) on the pitch/chroma correctness;
  chroma via nearest-octave fold.

Every behavior here is pinned by hand-derived fixtures in
tests/test_mel_eval_fixtures.py (expected values computed by hand from the
published mir_eval.melody algorithms — the library itself is not
installable in this environment).

Also provides librosa-style midi<->hz conversion used throughout the
reference label pipeline.

A NumPy/SciPy copy of viterbi_spl_tpu/metrics/mel_eval.py.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d


def hz_to_midi(freqs):
    """librosa.hz_to_midi semantics: 12*log2(f/440)+69; 0 Hz stays 0."""
    freqs = np.asarray(freqs, np.float64)
    out = np.zeros_like(freqs)
    nz = freqs > 0
    out[nz] = 12.0 * np.log2(freqs[nz] / 440.0) + 69.0
    return out


def midi_to_hz(notes):
    notes = np.asarray(notes, np.float64)
    return 440.0 * 2.0 ** ((notes - 69.0) / 12.0)


def hz2cents(freqs, base_frequency: float = 10.0):
    """Hz -> cents above base_frequency; zeros stay zero."""
    freqs = np.asarray(freqs, np.float64)
    out = np.zeros_like(freqs)
    nz = freqs > 0
    out[nz] = 1200.0 * np.log2(freqs[nz] / base_frequency)
    return out


def freq_to_voicing(freqs):
    """(|freqs|, freqs > 0) — negative frequency encodes an unvoiced estimate."""
    freqs = np.asarray(freqs, np.float64)
    return np.abs(freqs), freqs > 0


def constant_hop_timebase(hop: float, end_time: float) -> np.ndarray:
    return np.arange(int(np.floor(end_time / hop)) + 1) * hop


def resample_melody_series(times, frequencies, voicing, times_new, kind="linear"):
    """Resample a (times, frequency-in-cents, voicing) series to new times
    (mir_eval.melody.resample_melody_series semantics).

    Frequencies are held through zeros and interpolated with `kind`; a
    zero-order mask re-zeroes resampled points whose source was 0; voicing
    is zero-order-hold resampled. When `times_new` extends past `times`,
    one terminal (freq=0, unvoiced) sample is appended at the new end time
    (mir_eval does NOT hold the edge: the final query lands on that
    appended sample and comes back unvoiced)."""
    # mir_eval rounds both timebases to 10 decimals to dodge fp jitter
    times = np.round(np.asarray(times, np.float64), 10)
    frequencies = np.asarray(frequencies, np.float64)
    voicing = np.asarray(voicing)
    times_new = np.round(np.asarray(times_new, np.float64), 10)

    if times.shape == times_new.shape and np.allclose(times, times_new):
        return frequencies.copy(), voicing.astype(bool)

    if times_new.max() > times.max():
        times = np.append(times, times_new.max())
        frequencies = np.append(frequencies, 0.0)
        voicing = np.append(voicing, 0)

    freq_held = frequencies.copy()
    for n in range(1, len(freq_held)):
        if freq_held[n] == 0:
            freq_held[n] = freq_held[n - 1]

    def interp(y, k):
        f = interp1d(times, y, kind=k, assume_sorted=True)
        return f(times_new)

    freq_resampled = interp(freq_held, kind)
    freq_mask = interp(frequencies, "zero")
    freq_resampled = freq_resampled * (freq_mask != 0)
    voicing_resampled = interp(voicing.astype(np.float64), "zero")
    return freq_resampled, voicing_resampled.astype(bool)


def to_cent_voicing(ref_time, ref_freq, est_time, est_freq, hop=None, kind="linear"):
    """Common-timebase conversion: returns (ref_voicing, ref_cent,
    est_voicing, est_cent) on the reference timebase (or a constant-hop
    timebase when `hop` is given)."""
    ref_time = np.asarray(ref_time, np.float64)
    ref_freq = np.asarray(ref_freq, np.float64)
    est_time = np.asarray(est_time, np.float64)
    est_freq = np.asarray(est_freq, np.float64)

    if ref_time[0] > 0:
        ref_time = np.insert(ref_time, 0, 0.0)
        ref_freq = np.insert(ref_freq, 0, ref_freq[0])
    if est_time[0] > 0:
        est_time = np.insert(est_time, 0, 0.0)
        est_freq = np.insert(est_freq, 0, est_freq[0])

    ref_freq_abs, ref_voicing = freq_to_voicing(ref_freq)
    est_freq_abs, est_voicing = freq_to_voicing(est_freq)
    ref_cent = hz2cents(ref_freq_abs)
    est_cent = hz2cents(est_freq_abs)

    if hop is not None:
        ref_cent, ref_voicing = resample_melody_series(
            ref_time, ref_cent, ref_voicing,
            constant_hop_timebase(hop, ref_time.max()), kind,
        )
        est_cent, est_voicing = resample_melody_series(
            est_time, est_cent, est_voicing,
            constant_hop_timebase(hop, est_time.max()), kind,
        )
    else:
        est_cent, est_voicing = resample_melody_series(
            est_time, est_cent, est_voicing, ref_time, kind
        )

    len_diff = len(ref_cent) - len(est_cent)
    if len_diff >= 0:
        est_cent = np.append(est_cent, np.zeros(len_diff))
        est_voicing = np.append(est_voicing, np.zeros(len_diff, bool))
    else:
        est_cent = est_cent[: len(ref_cent)]
        est_voicing = est_voicing[: len(ref_cent)]

    return ref_voicing.astype(bool), ref_cent, est_voicing.astype(bool), est_cent


def voicing_measures(ref_voicing, est_voicing):
    """(recall, false_alarm); zero denominators give 0."""
    ref_voicing = np.asarray(ref_voicing, bool)
    est_voicing = np.asarray(est_voicing, bool)
    n_voiced = ref_voicing.sum()
    n_unvoiced = (~ref_voicing).sum()
    tp = np.logical_and(ref_voicing, est_voicing).sum()
    fp = np.logical_and(~ref_voicing, est_voicing).sum()
    recall = tp / n_voiced if n_voiced > 0 else 0.0
    false_alarm = fp / n_unvoiced if n_unvoiced > 0 else 0.0
    return float(recall), float(false_alarm)


def raw_pitch_accuracy(ref_voicing, ref_cent, est_voicing, est_cent, cent_tolerance=50.0):
    """Fraction of ref-voiced frames whose estimate is within the tolerance
    (STRICT `<`, over frames where both cent values are nonzero — the
    published mir_eval.melody.raw_pitch_accuracy)."""
    ref_voicing = np.asarray(ref_voicing, bool)
    ref_cent = np.asarray(ref_cent)
    est_cent = np.asarray(est_cent)
    n_voiced = ref_voicing.sum()
    if n_voiced == 0:
        return 0.0
    nonzero = np.logical_and(ref_cent != 0, est_cent != 0)
    correct = np.abs(ref_cent - est_cent) < cent_tolerance
    return float((ref_voicing & nonzero & correct).sum() / n_voiced)


def raw_chroma_accuracy(ref_voicing, ref_cent, est_voicing, est_cent, cent_tolerance=50.0):
    ref_voicing = np.asarray(ref_voicing, bool)
    ref_cent = np.asarray(ref_cent)
    est_cent = np.asarray(est_cent)
    n_voiced = ref_voicing.sum()
    if n_voiced == 0:
        return 0.0
    nonzero = np.logical_and(ref_cent != 0, est_cent != 0)
    diff = np.abs(ref_cent - est_cent)
    folded = np.abs(diff - 1200.0 * np.floor(diff / 1200.0 + 0.5))
    correct = folded < cent_tolerance
    return float((ref_voicing & nonzero & correct).sum() / n_voiced)


def overall_accuracy(ref_voicing, ref_cent, est_voicing, est_cent, cent_tolerance=50.0):
    ref_voicing = np.asarray(ref_voicing, bool)
    est_voicing = np.asarray(est_voicing, bool)
    ref_cent = np.asarray(ref_cent)
    est_cent = np.asarray(est_cent)
    n = len(ref_voicing)
    if n == 0:
        return 0.0
    nonzero = np.logical_and(ref_cent != 0, est_cent != 0)
    pitch_ok = np.abs(ref_cent - est_cent) < cent_tolerance
    correct = np.logical_or(
        ref_voicing & est_voicing & nonzero & pitch_ok,
        ~ref_voicing & ~est_voicing,
    )
    return float(correct.sum() / n)


def evaluate_melody(ref_time, ref_freq, est_time, est_freq, cent_tolerance=50.0):
    """mir_eval.melody.evaluate-equivalent: dict of the five frame metrics."""
    ref_v, ref_c, est_v, est_c = to_cent_voicing(ref_time, ref_freq, est_time, est_freq)
    recall, false_alarm = voicing_measures(ref_v, est_v)
    return {
        "Voicing Recall": recall,
        "Voicing False Alarm": false_alarm,
        "Raw Pitch Accuracy": raw_pitch_accuracy(ref_v, ref_c, est_v, est_c, cent_tolerance),
        "Raw Chroma Accuracy": raw_chroma_accuracy(ref_v, ref_c, est_v, est_c, cent_tolerance),
        "Overall Accuracy": overall_accuracy(ref_v, ref_c, est_v, est_c, cent_tolerance),
    }


def est_notes_with_voicing_to_hz(est_notes, min_note: float) -> np.ndarray:
    """Signed MIDI notes -> signed Hz (negative = unvoiced), per the
    reference convention (dcnet/softmax_viterbi.py:3160-3176)."""
    est_notes = np.asarray(est_notes, np.float64)
    if not np.all((est_notes >= min_note) | (est_notes <= -min_note)):
        raise ValueError("est notes must be signed-magnitude >= min_note")
    return np.where(est_notes > 0, midi_to_hz(est_notes), -midi_to_hz(-est_notes))
