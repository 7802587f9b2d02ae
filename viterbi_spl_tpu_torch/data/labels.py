"""Reference-melody label readers for the five evaluation datasets
(counterpart of viterbi_spl_tpu/data/labels.py; NumPy only).

Per-dataset semantics mirror the reference readers (SURVEY.md §2.7):
- MedleyDB: MELODY2 csv at hop 256/44100, frequencies masked by per-frame
  vocal activity -> MIDI notes, 0 = unvoiced (dcnet/softmax_viterbi.py:492-513),
- ADC04: <track>REF.txt, hop 256/44100 (timebase asserted) (:860-879),
- MIREX05: <track>REF.txt at 10 ms, resampled to the 256-hop grid with the
  mir_eval resampling semantics (:1017-1051),
- MIR-1K: PitchLabel .pv files (MIDI pitches at 20 ms starting at 20 ms;
  a 0 frame is prepended), resampled to the 256-hop 44.1 kHz grid even
  though the audio is 16 kHz (441/128 sample ratio) (:1197-1241),
- RWC: MELODY annotation files.

Each reader returns dict(notes=[T] float MIDI on the model's hop grid,
original=dict(times, freqs)) — `original` feeds the mir_eval-semantics
cross-check exactly like the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..metrics.mel_eval import hz_to_midi, midi_to_hz, resample_melody_series

MIN_MELODY_FREQ = 20.0
HOP_256 = 256.0 / 44100.0


def validity_check_of_ref_freqs(freqs: np.ndarray) -> None:
    """Frequencies must be exactly 0 (unvoiced) or above the minimum melody
    frequency (dcnet/softmax_viterbi.py:577-585)."""
    freqs = np.asarray(freqs)
    ok = (freqs == 0.0) | (freqs > MIN_MELODY_FREQ)
    if not np.all(ok):
        raise ValueError("reference frequencies outside the valid melody range")


def notes_from_freqs(freqs: np.ndarray) -> np.ndarray:
    """Hz -> MIDI with 0 staying 0 (librosa-equivalent hz_to_midi)."""
    return hz_to_midi(freqs).astype(np.float32)


def read_times_freqs(path: str | os.PathLike, delimiter=None) -> np.ndarray:
    arr = np.genfromtxt(path, delimiter=delimiter)
    if np.any(np.isnan(arr)) or arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"bad annotation file {path}")
    return arr


def medleydb_label(track_id: str, is_vocals: np.ndarray, melody2_dir: str | None = None) -> dict:
    """MELODY2 csv + per-frame vocal mask -> labels on the 256-hop grid."""
    melody2_dir = melody2_dir or os.environ["melody2_dir"]
    arr = read_times_freqs(
        os.path.join(melody2_dir, track_id + "_MELODY2.csv"), delimiter=","
    )
    n = len(arr)
    expected_times = np.arange(n) * HOP_256
    # rtol=0: the default rtol scales tolerance with absolute time, so a
    # dropped+duplicated interior row near t~1000 s would pass
    if not np.allclose(arr[:, 0], expected_times, rtol=0, atol=1e-4):
        raise ValueError("MELODY2 timebase is not the 256-hop grid")
    freqs = arr[:, 1]
    validity_check_of_ref_freqs(freqs)
    if len(is_vocals) != n:
        raise ValueError("vocal mask length mismatch")
    vocal_freqs = np.where(np.asarray(is_vocals, bool), freqs, 0.0)
    return dict(
        notes=notes_from_freqs(vocal_freqs),
        original=dict(times=arr[:, 0], freqs=vocal_freqs),
    )


def adc04_label(track_id: str, root: str | None = None) -> dict:
    root = root or os.environ["adc04"]
    arr = read_times_freqs(os.path.join(root, track_id + "REF.txt"))
    n = len(arr)
    if int(round(arr[-1, 0] / HOP_256)) + 1 != n or arr[0, 0] != 0.0:
        raise ValueError("ADC04 timebase is not the 256-hop grid")
    freqs = arr[:, 1]
    validity_check_of_ref_freqs(freqs)
    return dict(
        notes=notes_from_freqs(freqs),
        original=dict(times=arr[:, 0], freqs=freqs),
    )


def mirex05_label(track_id: str, root: str | None = None) -> dict:
    root = root or os.environ["mirex05"]
    name = "train13REF.txt" if track_id == "train13MIDI" else track_id + "REF.txt"
    arr = read_times_freqs(os.path.join(root, name))
    n = len(arr)
    if int(round(arr[-1, 0] / 0.01)) + 1 != n or arr[0, 0] != 0.0:
        raise ValueError("MIREX05 timebase is not the 10 ms grid")
    freqs_441 = arr[:, 1]
    validity_check_of_ref_freqs(freqs_441)

    n_256 = ((n - 1) * 441 + 255) // 256 + 1
    times_256 = np.arange(n_256) * HOP_256
    times_441 = np.arange(n) * 0.01
    freqs_256, _ = resample_melody_series(
        times_441, freqs_441, freqs_441 > 0.1, times_256
    )
    validity_check_of_ref_freqs(freqs_256)
    return dict(
        notes=notes_from_freqs(freqs_256),
        original=dict(times=arr[:, 0], freqs=freqs_441),
    )


def mir1k_label(track_id: str, num_samples_16k: int, root: str | None = None) -> dict:
    """PitchLabel .pv (MIDI at 20 ms, first frame at 20 ms) -> 256-hop grid.

    NOTE: the .pv values are already MIDI pitches; resampling happens in the
    pitch domain and `original.freqs` converts back to Hz
    (dcnet/softmax_viterbi.py:1197-1241)."""
    root = root or os.environ["mir1k"]
    pitches = np.genfromtxt(os.path.join(root, "PitchLabel", track_id + ".pv"))
    if np.any(np.isnan(pitches)) or pitches.ndim != 1:
        raise ValueError("bad .pv file")
    n = len(pitches)
    w = 640
    if (num_samples_16k - w) // 320 + 1 != n:
        raise ValueError("pitch file length inconsistent with audio")
    if not np.all((pitches > 23) | (pitches == 0)):
        raise ValueError("pitch values out of range")

    n = n + 1
    times_20ms = np.arange(n) * 0.02
    pitches = np.pad(pitches, (1, 0))

    n_256 = ((n - 1) * 441 + 127) // 128 + 1
    times_256 = np.arange(n_256) * HOP_256
    pitches_256, _ = resample_melody_series(
        times_20ms, pitches, pitches > 0.1, times_256
    )
    if not np.all((pitches_256 == 0) | (pitches_256 > 23)):
        raise ValueError("resampled pitches out of range")
    freqs = np.where(pitches > 0, midi_to_hz(pitches), 0.0)
    return dict(
        notes=pitches_256.astype(np.float32),
        original=dict(times=times_20ms, freqs=freqs),
    )


def tonet_f0ref_label(track_id: str, root: str | None = None) -> dict:
    """Yu's precomputed 10 ms f0 reference for the tonet harness:
    $fatnet_spec/f0ref/<track>_MIX.txt with (time, freq) rows on the 10 ms
    grid starting at 0 (tonet/main_shaun.py:386-406 gen_label_yu_fn)."""
    root = root or os.environ["fatnet_spec"]
    arr = read_times_freqs(os.path.join(root, "f0ref", track_id + "_MIX.txt"))
    n = len(arr)
    if n == 0:
        raise ValueError(f"empty f0ref file for {track_id}")
    # validate the FULL time column (endpoint checks alone would accept a
    # file with a dropped+duplicated interior row, silently shifting every
    # later frequency off its frame) — same pattern as medleydb_label.
    # rtol=0: uniform strictness along the whole column (default rtol
    # approaches one full frame of slack near t~1000 s)
    if not np.allclose(arr[:, 0], np.arange(n) * 0.01, rtol=0, atol=1e-4):
        raise ValueError("f0ref timebase is not the 10 ms grid")
    freqs = arr[:, 1]
    validity_check_of_ref_freqs(freqs)
    return dict(
        notes=notes_from_freqs(freqs),
        original=dict(times=np.arange(n) * 0.01, freqs=freqs),
    )


def resample_notes_to_10ms(notes_256: np.ndarray) -> np.ndarray:
    """256-hop labels -> 10 ms grid for the jdc/ftanet/tonet families
    (jdc/kum_m2m3.py:389-421 semantics, in the pitch domain)."""
    n = len(notes_256)
    times_256 = np.arange(n) * HOP_256
    n_10ms = int(np.floor(times_256[-1] / 0.01)) + 1
    times_10ms = np.arange(n_10ms) * 0.01
    notes, _ = resample_melody_series(times_256, notes_256, notes_256 > 0.1, times_10ms)
    return notes.astype(np.float32)


def rwc_rec_files(root: str | None = None) -> list[str]:
    """The 100 RWC popular-music aiff paths across the 7-disk layout
    (dcnet/main.py:1346-1385): recordings are numbered consecutively across
    disks; each file name starts with its within-disk index."""
    import glob

    root = root or os.environ["rwc"]
    dir_path = os.path.join(root, "popular", "RWC-MDB-P-2001-M0")
    per_disk = []
    for disk in range(1, 8):
        per_disk.append(sorted(glob.glob(os.path.join(dir_path + str(disk), "*.aiff"))))
    counts = np.cumsum([len(d) for d in per_disk])
    if counts[-1] != 100:
        raise ValueError(f"expected 100 RWC recordings, found {counts[-1]}")
    starts = np.concatenate([[0], counts])
    rec_files = []
    for rec_idx in range(100):
        disk = int(np.searchsorted(starts, rec_idx, side="right")) - 1
        within = rec_idx - starts[disk] + 1
        for f in per_disk[disk]:
            if os.path.basename(f).split()[0] == str(within):
                rec_files.append(f)
                break
        else:
            raise FileNotFoundError(f"RWC recording {rec_idx} not found")
    return rec_files


def rwc_melody_freqs(rec_idx: int, aiff_num_frames: int, root: str | None = None) -> np.ndarray:
    """AIST MELODY.TXT -> per-10ms-frame frequencies (dcnet/main.py:1431-1461).

    Lines are '<frame> <frame> m <freq> <...>'; frames without an entry are
    unvoiced (0)."""
    root = root or os.environ["rwc"]
    path = os.path.join(
        root, "popular", "AIST.RWC-MDB-P-2001.MELODY",
        f"RM-P{rec_idx + 1:03d}.MELODY.TXT",
    )
    freqs = np.zeros(aiff_num_frames, np.float32)
    with open(path) as fh:
        for line in fh:
            cols = line.split()
            if len(cols) != 5 or cols[0] != cols[1] or cols[2] != "m":
                raise ValueError(f"bad MELODY.TXT line: {line!r}")
            frame_idx = int(cols[0])
            freq = float(cols[3])
            if not (freq == 0 or freq > 31.0):
                raise ValueError(f"bad RWC melody frequency {freq}")
            if frame_idx >= aiff_num_frames:
                raise ValueError("melody annotation longer than audio")
            freqs[frame_idx] = freq
    return freqs


def rwc_label(rec_idx: int, aiff_num_frames: int, root: str | None = None) -> dict:
    """RWC labels resampled from the 10 ms grid to the 256-hop grid
    (dcnet/main.py:1463-1490)."""
    freqs_441 = rwc_melody_freqs(rec_idx, aiff_num_frames, root)
    n = len(freqs_441)
    n_256 = 1 + ((n - 1) * 441 + 255) // 256
    times_441 = np.arange(n) * 0.01
    times_256 = np.arange(n_256) * HOP_256
    validity_check_of_ref_freqs(freqs_441)
    freqs_256, _ = resample_melody_series(
        times_441, freqs_441, freqs_441 > 0.1, times_256
    )
    validity_check_of_ref_freqs(freqs_256)
    return dict(
        notes=notes_from_freqs(freqs_256),
        original=dict(times=times_441, freqs=freqs_441),
    )
