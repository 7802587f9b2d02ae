"""Test data for the banded backtrace (K2 and its plain versions), shared
by the tests and chip_smoke.py: a t1m1 whose chase meets two equal maxima
at every step."""

from __future__ import annotations

import numpy as np

from .viterbi_banded import BandedStructure, rebuilt_rows


def _tie_value(rng, addends) -> tuple[np.float32, list]:
    """(c, [v]): a value c in [-60, -40) and, for each f32 addend r, a v with
    f32(v + r) == c exactly."""
    for _ in range(10000):
        c = np.float32(rng.uniform(-60.0, -40.0))
        vs = []
        for r in addends:
            v0 = np.float32(c - np.float32(r))
            for v in (v0, np.nextafter(v0, np.float32(np.inf)), np.nextafter(v0, np.float32(-np.inf))):
                if np.float32(v + np.float32(r)) == c:
                    vs.append(v)
                    break
            else:
                break
        if len(vs) == len(addends):
            return c, vs
    raise RuntimeError("no exact tie found")


def _out_of_band(rng, s: int, d_max: int, n: int) -> int:
    """A voiced source x (x < n) with |x - s| > d_max, uniformly."""
    left, right = max(0, s - d_max), max(0, n - 1 - s - d_max)  # counts below / above the band
    k = int(rng.integers(0, left + right))
    return k if k < left else s + d_max + 1 + (k - left)


def tie_fixture(bs: BandedStructure, rng, lengths, T: int):
    """A backtrace input whose chase meets a tie at every step, for the
    first-max rule of K2 and its pass: (t1m1 [N, T, S] f32, last states [N],
    path [N, T]). Built backward along each track: at frame t >= 1 the row
    of the path's state s_t (logB[s_t, :] rebuilt) has exactly two equal
    maxima, by turns two in-band sources, an in-band and an out-of-band one
    (either first), an out-of-band voiced source and the unvoiced one, an
    in-band source and the unvoiced one; for the unvoiced target two voiced
    sources, or a voiced one and the unvoiced. Every other candidate of that
    row is at least ~1,900 below. The lower source wins and is s_{t-1}.
    Frames at or beyond a track's length hold other values. Row 0 is 0, as
    K1 writes it."""
    rows = rebuilt_rows(bs, "cpu").numpy()
    S, n, d_max = bs.S, bs.n_bins, bs.d_max
    N = len(lengths)
    t1m1 = rng.uniform(-30.0, 0.0, (N, T, S)).astype(np.float32)
    path = np.zeros((N, T), np.int64)
    last = rng.integers(0, S, N)
    for i, L in enumerate(lengths):
        s = int(last[i])
        path[i, L - 1] = s
        t1m1[i, 0] = 0.0
        for t in range(L - 1, 0, -1):
            base = np.float32(rng.uniform(-60.0, -40.0))
            row = (base - 2000.0 - 10.0 * rng.random(S)).astype(np.float32)
            lo, hi = max(0, s - d_max), min(n - 1, s + d_max)
            out_of_band = n > 2 * d_max + 1  # some voiced source lies outside the band
            kind = t % 4
            if s == n:
                x1 = int(rng.integers(0, n - 1))
                pair = (x1, int(rng.integers(x1 + 1, n))) if kind % 2 else (x1, n)
            elif kind == 0 and hi > lo:
                x1 = int(rng.integers(lo, hi))
                pair = (x1, int(rng.integers(x1 + 1, hi + 1)))
            elif kind == 1 and out_of_band:
                pair = (int(rng.integers(lo, hi + 1)), _out_of_band(rng, s, d_max, n))
            elif kind == 2 and out_of_band:
                pair = (_out_of_band(rng, s, d_max, n), n)
            else:
                pair = (int(rng.integers(lo, hi + 1)), n)
            _, vs = _tie_value(rng, [rows[s, x] for x in pair])
            for x, v in zip(pair, vs):
                row[x] = v
            t1m1[i, t] = row
            s = min(pair)
            path[i, t - 1] = s
    return t1m1, last.astype(np.int32), path
