"""The port's NSGT front-end (viterbi_spl_tpu_torch/frontend/nsgt.py) against
the JAX package's, on the CPU, at tests/test_nsgt.py's size (NSGT(2**16)).

Tolerances and where they come from:
- the window and index tables: equal, index for index (both NumPy).
- the forward coefficients and the transform_track magnitudes: atol 1e-6
  (the port computes in float64, the JAX package in float32; the
  magnitudes peak near 0.45).
- dcnet_feature: within 1e-4 of the JAX values (its range is [0, 1]): the
  port's float64 chain against the JAX package's float32 one, whose own
  error a probe measured at 5.3e-5 at most against a float64 forward.
- the round trip: tests/test_nsgt.py's SNR bound, 50 dB.
- the overlap-save blocking (track_blocks): the JAX package's blocks and
  kept frames, equal.
"""

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.frontend import nsgt as JN
from viterbi_spl_tpu_torch.frontend import nsgt as TN

COEF_ATOL = 1e-6
FEATURE_ATOL = 1e-4
SNR_DB = 50.0


@pytest.fixture(scope="module")
def pair():
    return JN.NSGT(2**16), TN.NSGT(2**16, device="cpu")


def synth(rng, n, sr=44100):
    """tests/test_nsgt.py's signal: two partials and noise."""
    t = np.arange(n) / sr
    y = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 555 * t) \
        + 0.05 * rng.normal(size=n)
    return y.astype(np.float32)


def test_tables_equal_jax(pair):
    j, t = pair
    for name in ("Lfbas", "n_out_bands", "max_bw", "uni_side_cyc_frames", "num_frames_per_Ls"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.posit, j.posit)
    np.testing.assert_array_equal(t.bw, j.bw)
    for name in ("_fwd_src", "_fwd_sign", "_fwd_w", "_inv_gather", "_inv_scatter", "_inv_w"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_forward_and_round_trip_match_jax(rng, pair):
    j, t = pair
    y = synth(rng, t.Ls)
    got = t.forward(y)
    assert got.dtype == torch.complex128 and got.shape == (568, t.max_bw)
    want = np.asarray(j.forward(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COEF_ATOL)
    y2 = t.inverse(got).numpy()
    snr = 10 * np.log10(np.sum(y.astype(np.float64) ** 2) / np.sum((y2 - y) ** 2))
    assert snr > SNR_DB, snr
    np.testing.assert_allclose(y2, np.asarray(j.inverse(want)), rtol=0, atol=COEF_ATOL)


@pytest.mark.parametrize("length", [2.2, 0.3])
def test_transform_track_and_feature_match_jax(rng, pair, length):
    """Over 2.2 Ls (four blocks, three seams) and over 0.3 Ls (the single
    zero-padded block a short clip takes)."""
    j, t = pair
    y = synth(rng, int(length * t.Ls) + 37)
    got, want = t.transform_track(y), j.transform_track(y)
    assert got.shape == want.shape == (-(-len(y) // 64), 568) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=COEF_ATOL)
    fg, fw = TN.dcnet_feature(got), JN.dcnet_feature(want)
    assert fg.shape == fw.shape and fg.shape[1] == 500
    np.testing.assert_allclose(fg, fw, rtol=0, atol=FEATURE_ATOL)
    # the port's own magnitudes through the JAX package's feature: equal
    np.testing.assert_array_equal(fg, JN.dcnet_feature(got))


def test_track_blocks_are_the_jax_blocks(rng, pair, monkeypatch):
    """The blocks transform_track cuts (four over 2.2 Ls) are the ones the
    JAX package's transform_track sends through its forward, in order."""
    j, t = pair
    y = synth(rng, int(2.2 * t.Ls))
    blocks, keep, frames = t.track_blocks(y)
    assert len(blocks) == len(keep) == 4 and frames == -(-len(y) // 64)
    seen = []
    real = j._forward
    monkeypatch.setattr(j, "_forward", lambda seg: seen.append(np.asarray(seg)) or real(seg))
    j.transform_track(y)
    assert len(seen) == len(blocks)
    for got, want in zip(blocks, seen):
        np.testing.assert_array_equal(got, want)
    cyc = t.uni_side_cyc_frames
    assert [a for a, _ in keep] == [cyc] * 4 and sum(n for _, n in keep) >= frames


def test_nsgt_for_length_matches_jax():
    for n in (1000, 2**17, 2**18 - 1, 2**18, int(2**18 * 1.5)):
        assert TN.nsgt_for_length(n, device="cpu").Ls == JN.nsgt_for_length(n).Ls, n
    a = TN.nsgt_for_length(2**17 + 1, device="cpu")
    assert TN.nsgt_for_length(2**18 - 1, device="cpu") is a  # one instance per (Ls, device)
    with pytest.raises(ValueError, match="power of two"):
        TN.NSGT(3000, device="cpu")
