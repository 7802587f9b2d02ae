"""Per-frame vocal-activity labels for MedleyDB tracks (the port's own copy
of viterbi_spl_tpu/data/vocals.py, NumPy only).

Two mechanisms, mirroring self_defined/is_vocals.py:

- `is_vocals_from_sections` (is_vocals_singer_fn, :108-152): derives the
  mask from SOURCEID section files — frames inside any 'singer' section,
  intersected with melody2 voicing. Works from plain annotation files.
- `is_vocals_from_m2m3` (is_vocals_m2m3_fn, :19-105): matches melody2
  against the per-instrument melody3 columns with instrument rankings.
  Annotation access is injected (the reference uses the `medleydb` package,
  unavailable here) via a dict argument.
"""

from __future__ import annotations

import os

import numpy as np

HOP = 256
SR = 44100


def is_vocals_from_sections(
    track_id: str,
    section_dir: str | None = None,
    melody2_dir: str | None = None,
) -> np.ndarray:
    melody2_dir = melody2_dir or os.environ["melody2_dir"]
    section_dir = section_dir or os.environ["section_dir"]

    arr = np.genfromtxt(
        os.path.join(melody2_dir, track_id + "_MELODY2.csv"), delimiter=","
    )
    n = len(arr)
    if not np.all(np.arange(n) * (HOP / SR) == arr[:, 0]):
        raise ValueError("MELODY2 timebase mismatch")

    is_vocals = np.zeros(n, bool)
    hh = HOP // 2
    with open(os.path.join(section_dir, track_id + "_SOURCEID.lab")) as fh:
        for line in fh:
            if "start_time" in line:
                continue
            parts = line.split(",")
            if "singer" not in parts[-1]:
                continue
            ss = int(np.ceil(float(parts[0]) * SR))
            es = int(np.floor(float(parts[1]) * SR))
            sf = (ss + hh) // HOP
            ef = (es + hh) // HOP
            is_vocals[sf : ef + 1] = True

    return np.logical_and(is_vocals, arr[:, 1] > 0.0)


def is_vocals_from_m2m3(
    melody2: np.ndarray,
    melody3: np.ndarray,
    melody_rankings: dict[int, int],
    stem_instruments: dict[int, str],
    is_instrumental: bool,
) -> np.ndarray:
    """melody2: [T, 2] (time, freq); melody3: [T, 1 + n_insts];
    melody_rankings: stem -> rank (1-based); stem_instruments: stem -> name.

    A frame is vocal iff its melody2 frequency matches exactly the melody3
    column of a 'singer'/'vocalists' stem (with the reference's ambiguity
    resolution when several columns match)."""
    n = len(melody2)
    n_insts = melody3.shape[1] - 1
    vocal_cols = np.zeros(n_insts, bool)
    for stem, rank in melody_rankings.items():
        inst = stem_instruments[stem]
        if "singer" in inst or "vocalists" in inst:
            vocal_cols[rank - 1] = True

    is_vocals = np.zeros(n, bool)
    if is_instrumental:
        if vocal_cols.any():
            raise ValueError("instrumental track with vocal melody ranks")
        return is_vocals

    for idx in range(n):
        f2 = melody2[idx, 1]
        if f2 == 0:
            continue
        matches = melody3[idx, 1:] == f2
        n_match = int(matches.sum())
        if n_match == 0:
            raise ValueError(f"melody2 frame {idx} not found in melody3")
        if n_match == 1:
            if vocal_cols[int(np.argmax(matches))]:
                is_vocals[idx] = True
        else:
            # ambiguous: vocal wins if any matching column is vocal
            if np.any(matches & vocal_cols):
                is_vocals[idx] = True
    if not is_vocals.any():
        raise ValueError("non-instrumental track produced an empty vocal mask")
    return is_vocals
