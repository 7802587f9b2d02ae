"""The yardstick's arithmetic against hand-computed cases."""

from __future__ import annotations

import pytest
import torch

from perfbench import work


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert work.bound(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound(0, 67e12) == pytest.approx(1.0)
    assert work.bound(3.35e9, 67e12) == pytest.approx(1.0)
    assert work.bound(6.7e12, 67e12) == pytest.approx(2.0)


def test_inband_pairs_counts_the_clipped_band():
    # 5 bins, d_max 1: 2 + 3 + 3 + 3 + 2
    assert work.inband_pairs(5, 1) == 13
    assert work.inband_pairs(4, 10) == 16  # the band covers every pair


def test_forward_and_backtrace_work_by_hand():
    S, d, lengths = 5, 1, [3, 2]  # 4 voiced bins, 5 frames, 3 steps
    nbytes, ops = work.forward_work(S, d, lengths)
    assert nbytes == 2 * 5 * 4 * S
    inband = 2 + 3 + 3 + 2
    assert ops == 3 * (2 * inband + 4 * 4 + 4 + 4)
    assert work.backtrace_work(S, lengths) == (3 * 4 * S + 5 * 4, 3 * 2 * S)


def test_obs_work_by_hand():
    assert work.obs_work(10, 2, 7, 3) == (7 * 21 * 4, 7 * 10 * 5 + 18)


def test_decode_bound_reads_logits_and_writes_states_once():
    S, d, spw, lengths, peaks = 5, 1, 2, [3, 2], 4
    frames = 5
    o_ops = work.obs_work(S - 1, spw, frames, peaks)[1]
    ops = o_ops + work.forward_work(S, d, lengths)[1] + work.backtrace_work(S, lengths)[1]
    assert work.decode_bound(S, d, spw, lengths, peaks) == pytest.approx(
        max(frames * (4 * 4 + 4) / 3.35e12, ops / 67e12))
    assert work.fused_forward_bound(S, d, spw, lengths, peaks) == pytest.approx(
        work.bound(work.obs_work(S - 1, spw, frames, peaks)[0],
                   o_ops + work.forward_work(S, d, lengths)[1]))


def test_model_flops_counts_two_per_multiply_add():
    with torch.device("meta"):
        lin = torch.nn.Linear(8, 3)
        conv = torch.nn.Conv1d(2, 4, 3, padding=1)
    assert work.model_flops(lin, torch.empty(5, 8, device="meta")) == 2 * 5 * 8 * 3
    assert work.model_flops(conv, torch.empty(1, 2, 10, device="meta")) == 2 * 10 * 4 * 2 * 3


def test_tonet_flops_a_frame_grow_with_the_attention_width():
    small = work.tonet_flops_per_frame({"attn_dim": 32, "seg_frame": 128})
    big = work.tonet_flops_per_frame({"attn_dim": 64, "seg_frame": 128})

    def macs(d):
        """Multiply-adds a frame that depend on the width d: two branches,
        each with its 720 x d input projection, two encoder layers of 4 d^2
        (q, k, v, out) + 4 d^2 (FFN) and attention over 128 frames (q k^T
        and a v: 2 x 128 d), and its decoder's first layer (tone d x 512,
        octave d x 256)."""
        return 2 * 720 * d + 2 * 2 * 8 * d * d + 2 * 2 * 2 * 128 * d + (512 + 256) * d

    assert big - small == 2 * (macs(64) - macs(32))


def test_track_lengths_follow_the_traffic_file_whatever_the_run_seed():
    from perfbench import traffic

    spec = {"min": 400, "mode": 694, "max": 1300, "length_seed": 3}
    a, b = traffic.track_lengths(spec, 4000), traffic.track_lengths(spec, 4000)
    assert (a == b).all() and a.min() >= 400 and a.max() <= 1300
    assert abs(a.mean() - 798) < 10  # (min + mode + max) / 3
