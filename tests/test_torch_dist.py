"""The port's single-track decode (K7/K8's plain versions), its device mesh
and sequence-parallel / track-sharded decodes (dist/) and the `mesh=`
paths of the batch decode APIs, DecoderSetup and the decode CLI, against
the JAX package on the CPU. The JAX side runs as its own tests run it: on
the 8 virtual CPU devices of tests/conftest.py, with its Pallas kernels
interpreted; the port's mesh is ["cpu"] * n. Inputs come from numpy seeds.

Every comparison is exact (states, seam flags, final halos, T1 rows on
lanes [:S] and rows below each window's length): the DPs only add and take
maxima, in the same order in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_hmm
from test_dist import realistic_hmm
from test_torch_decode import _cli_inputs, _jax_setup, _logits
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.cli import decode as JD
from viterbi_spl_tpu.dist import decode_tracks_sharded as jax_decode_tracks_sharded
from viterbi_spl_tpu.dist import make_mesh as jax_make_mesh
from viterbi_spl_tpu.dist import viterbi_decode_time_sharded as jax_time_sharded
from viterbi_spl_tpu.dist import viterbi_sharded_time_blocks as jax_time_blocks
from viterbi_spl_tpu.dist.certify import make_seam_stress_hmm as jax_seam_stress_hmm
from viterbi_spl_tpu.dist.sharded_viterbi import viterbi_sharded_time_blocks_pallas
from viterbi_spl_tpu.hmm.oracle import viterbi_oracle
from viterbi_spl_tpu.hmm.viterbi import NEG_PAD
from viterbi_spl_tpu.hmm.viterbi import prepare_log_params as jax_log_params
from viterbi_spl_tpu.hmm.viterbi_pallas import (
    viterbi_backtrace_pallas,
    viterbi_decode_batch_pallas,
    viterbi_decode_pallas,
    viterbi_forward_pallas,
)
from viterbi_spl_tpu_torch.cli import decode as TD
from viterbi_spl_tpu_torch.dist import (
    decode_tracks_sharded,
    make_mesh,
    viterbi_decode_time_sharded,
    viterbi_sharded_time_blocks,
)
from viterbi_spl_tpu_torch.dist.certify import make_seam_stress_hmm
from viterbi_spl_tpu_torch.harness import evaluate as TE
from viterbi_spl_tpu_torch.hmm import obs_fused as OF
from viterbi_spl_tpu_torch.hmm import viterbi_dense as TVD
from viterbi_spl_tpu_torch.hmm.viterbi import prepare_log_params

LANE = 128
TINY = np.finfo(np.float32).tiny
CPU8 = ["cpu"] * 8


def _log(obs_ts):
    """NumPy's log(obs + TINY): the table both packages consume."""
    return np.log(obs_ts + TINY).astype(np.float32)


def _lane_padded(log_obs, P):
    out = np.full((log_obs.shape[0], P), NEG_PAD, np.float32)
    out[:, : log_obs.shape[1]] = log_obs
    return out


# ---- K7 / K8 and the single-track decode ---------------------------------


@pytest.mark.parametrize("S", [33, 361])
def test_window_kernels_plain_match_pallas(rng, S):
    """K7's and K8's plain versions, over one batch of ragged windows with
    reset rows 0, -1 and mid-window (H), against viterbi_forward_pallas /
    viterbi_backtrace_pallas (interpreted) window by window: t1_last and
    t1m1 on lanes [:S] and rows < T, and the states below T, bit for bit.
    The JAX side takes NEG_PAD lanes to 128 and its frames a multiple of
    16; the port takes neither."""
    W, H = 48, 16
    A, pi, _ = random_hmm(rng, S, 4)
    log_B, log_pi = prepare_log_params(A, pi)
    P = -(-S // LANE) * LANE
    jB, jpi = (jnp.asarray(x) for x in jax_log_params(A, pi, pad_to=P))
    cases = [(W, 0), (W, -1), (W, H), (37, H), (29, -1), (W - 3, 0)]
    lengths = np.array([T for T, _ in cases], np.int32)
    resets = np.array([r for _, r in cases], np.int32)
    log_obs = np.stack([_log(random_hmm(rng, S, W)[2].T) for _ in cases])
    t1_t, t1m1_t = TVD.window_forward(log_B, log_pi, torch.from_numpy(log_obs), lengths, resets)
    start = torch.argmax(t1_t, dim=1)
    states_t = TVD.window_backtrace(log_B, t1m1_t, start, lengths).numpy()
    for n, (T, r) in enumerate(cases):
        t1_j, t1m1_j = viterbi_forward_pallas(jB, jpi, jnp.asarray(_lane_padded(log_obs[n], P)),
                                              T, r, block_frames=16)
        np.testing.assert_array_equal(t1_t[n].numpy(), np.asarray(t1_j)[:S])
        np.testing.assert_array_equal(t1m1_t[n, :T].numpy(), np.asarray(t1m1_j)[:T, :S])
        assert int(start[n]) == int(np.argmax(np.asarray(t1_j)[:S]))
        st_j = viterbi_backtrace_pallas(t1m1_j, jB, int(start[n]), T, block_frames=16)
        np.testing.assert_array_equal(states_t[n, :T], np.asarray(st_j)[:T])


def _chase(bp, start, lengths):
    """s_{t-1} = bp[n, t, s_t] from start[n] at frame lengths[n] - 1."""
    states = np.zeros(bp.shape[:2], np.int32)
    for n, T in enumerate(lengths):
        s = int(start[n])
        states[n, T - 1] = s
        for t in range(T - 1, 0, -1):
            s = int(bp[n, t, s])
            states[n, t - 1] = s
    return states


@pytest.mark.parametrize("S", [33, 361])
def test_backpointer_pass_then_chase_matches_plain_and_pallas(rng, S):
    """K8's design on the card, in its plain version: every backpointer of
    every window (window_backpointers_plain), then a chase over them, gives
    window_backtrace_plain's states and viterbi_backtrace_pallas's
    (interpreted) below each length, with ragged windows, reset rows 0, -1
    and mid-window, and a tie-heavy window (uniform observations)."""
    W, H = 48, 16
    A, pi, _ = random_hmm(rng, S, 4)
    log_B, log_pi = prepare_log_params(A, pi)
    P = -(-S // LANE) * LANE
    jB, jpi = (jnp.asarray(x) for x in jax_log_params(A, pi, pad_to=P))
    cases = [(W, 0), (W, -1), (37, H), (2, 0), (1, 0), (W - 3, 0)]
    lengths = np.array([T for T, _ in cases], np.int32)
    resets = np.array([r for _, r in cases], np.int32)
    log_obs = np.stack([_log(random_hmm(rng, S, W)[2].T) for _ in cases])
    log_obs[-1] = _log(np.full((W, S), 1.0 / S, np.float32))
    t1, t1m1 = TVD.window_forward(log_B, log_pi, torch.from_numpy(log_obs), lengths, resets)
    start = torch.argmax(t1, dim=1)
    bp = TVD.window_backpointers_plain(torch.from_numpy(log_B), t1m1, lengths)
    assert bp.dtype == torch.int32 and bp.shape == (len(cases), W, S)
    got = _chase(bp.numpy(), start.numpy(), lengths)
    want = TVD.window_backtrace_plain(torch.from_numpy(log_B), t1m1, start, lengths).numpy()
    for n, (T, r) in enumerate(cases):
        np.testing.assert_array_equal(got[n, :T], want[n, :T])
        _, t1m1_j = viterbi_forward_pallas(jB, jpi, jnp.asarray(_lane_padded(log_obs[n], P)),
                                           T, r, block_frames=16)
        st_j = viterbi_backtrace_pallas(t1m1_j, jB, int(start[n]), T, block_frames=16)
        np.testing.assert_array_equal(got[n, :T], np.asarray(st_j)[:T])


@pytest.mark.parametrize("S,T", [(45, 100), (361, 40)])
def test_single_track_decode_matches_pallas_and_oracle(rng, S, T):
    A, pi, obs = random_hmm(rng, S, T, sparse_obs=True)
    got = TVD.viterbi_decode(transition_matrix=A, prob_init=pi, probs_st=obs, device="cpu")
    assert got.dtype == np.int64 and got.shape == (T,)
    np.testing.assert_array_equal(got, viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs))
    np.testing.assert_array_equal(
        got, viterbi_decode_pallas(transition_matrix=A, prob_init=pi, probs_st=obs, block_frames=16))


# ---- the mesh and the seam-stress fixture --------------------------------


def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(data=2, seq=4, devices=CPU8)
    assert mesh.shape == {"data": 2, "seq": 4}
    assert mesh.axis_devices("seq") == [torch.device("cpu")] * 4
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 2
    assert make_mesh(seq=4, devices=CPU8).shape == {"data": 2, "seq": 4}
    with pytest.raises(ValueError, match="needs more"):
        make_mesh(data=3, seq=3, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(seq=3, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(data=1)


def test_seam_stress_hmm_bit_equal_to_jax():
    for n_blocks in (2, 8):
        for got, want in zip(make_seam_stress_hmm(n_blocks), jax_seam_stress_hmm(n_blocks)):
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---- the sequence-parallel decode ----------------------------------------


def _realistic(seed, T=1024):
    A, pi, obs = realistic_hmm(np.random.default_rng(seed), n_bins=60, T=T)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = _log(obs.T)
    exact = viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs)
    return A, pi, log_B, log_pi, log_obs, exact


@pytest.mark.parametrize("halo", [16, 48])
def test_time_blocks_match_jax_scan_variant(halo):
    """States and seam flags equal to the JAX scan variant on 8 blocks, for
    seeds 0-3 (test_dist.py's inputs), and the certificate is sound: a seam
    set that passes means the exact path."""
    jmesh, mesh = jax_make_mesh(data=1, seq=8), make_mesh(seq=8, devices=CPU8)
    for seed in range(4):
        _, _, log_B, log_pi, log_obs, exact = _realistic(seed)
        want_states, want_seams = jax_time_blocks(
            jnp.asarray(log_B), jnp.asarray(log_pi), jnp.asarray(log_obs), jmesh, halo=halo)
        states, seams = viterbi_sharded_time_blocks(log_B, log_pi, torch.from_numpy(log_obs),
                                                    mesh, halo=halo)
        assert states.dtype == torch.int32 and seams.dtype == torch.bool
        np.testing.assert_array_equal(states.numpy(), np.asarray(want_states))
        np.testing.assert_array_equal(seams.numpy(), np.asarray(want_seams))
        assert np.array_equal(states.numpy(), exact) or not bool(seams.all()), (seed, halo)


def test_time_blocks_match_jax_pallas_variant(rng):
    """At halo 64 on test_dist.py's input: equal to the JAX Pallas variant
    (interpreted, lane-padded) and to the oracle."""
    A, pi, obs = realistic_hmm(rng, n_bins=60, T=1024)
    S = A.shape[0]
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = _log(obs.T)
    jB, jpi = jax_log_params(A, pi, pad_to=LANE)
    want_states, want_seams = viterbi_sharded_time_blocks_pallas(
        jnp.asarray(jB), jnp.asarray(jpi), jnp.asarray(_lane_padded(log_obs, LANE)),
        jax_make_mesh(data=1, seq=8), halo=64, S=S)
    states, seams = viterbi_sharded_time_blocks(log_B, log_pi, torch.from_numpy(log_obs),
                                                make_mesh(seq=8, devices=CPU8), halo=64)
    np.testing.assert_array_equal(states.numpy(), np.asarray(want_states))
    np.testing.assert_array_equal(seams.numpy(), np.asarray(want_seams))
    np.testing.assert_array_equal(
        states.numpy(), viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs))


def test_time_sharded_decode_matches_jax():
    """The certified decode returns JAX's states and final halo, for seeds
    0, 1 and 3 from halo 16: the exact path."""
    jmesh, mesh = jax_make_mesh(data=1, seq=8), make_mesh(seq=8, devices=CPU8)
    for seed in (0, 1, 3):
        _, _, log_B, log_pi, log_obs, exact = _realistic(seed)
        want, want_h = jax_time_sharded(jnp.asarray(log_B), jnp.asarray(log_pi),
                                        jnp.asarray(log_obs), jmesh, halo=16)
        got, h = viterbi_decode_time_sharded(log_B, log_pi, torch.from_numpy(log_obs), mesh,
                                             halo=16)
        assert h == want_h, seed
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), exact)


def test_forced_halo_doubling_episode():
    """On the seam-stress fixture the certificate fails at halos 16 and 32
    (without a wrong path passing) and passes at 64 with the exact path;
    the auto-halo decode from 16 returns 64. Below one halo per block, the
    decode falls back to the exact single-track decode and reports -1."""
    mesh = make_mesh(seq=8, devices=CPU8)
    A, pi, obs, switch = make_seam_stress_hmm(n_blocks=8)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = torch.from_numpy(_log(obs))
    exact = viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=obs.T)
    assert int(np.argmax(exact == 1)) == switch
    for halo, should_pass in ((16, False), (32, False), (64, True)):
        states, seams = viterbi_sharded_time_blocks(log_B, log_pi, log_obs, mesh, halo=halo)
        ok = bool(seams.all())
        match = np.array_equal(states.numpy(), exact)
        assert ok == should_pass and (match or not ok) and (match or not should_pass)
    states, final_halo = viterbi_decode_time_sharded(log_B, log_pi, log_obs, mesh, halo=16)
    assert final_halo == 64
    np.testing.assert_array_equal(states.numpy(), exact)
    states, final_halo = viterbi_decode_time_sharded(log_B, log_pi, log_obs, mesh, halo=16,
                                                     max_halo=32)
    assert final_halo == -1
    np.testing.assert_array_equal(states.numpy(), exact)


# ---- the track-sharded decodes -------------------------------------------


def test_decode_tracks_sharded_matches_jax_and_oracle(rng):
    S, T, N = 45, 64, 8
    A, pi, _ = random_hmm(rng, S, T)
    log_B, log_pi = prepare_log_params(A, pi)
    obs = [random_hmm(rng, S, T)[2] for _ in range(N)]
    log_obs = np.stack([_log(o.T) for o in obs])
    got = decode_tracks_sharded(log_B, log_pi, torch.from_numpy(log_obs),
                                make_mesh(data=8, devices=CPU8))
    assert got.dtype == torch.int32 and got.shape == (N, T)
    want = jax_decode_tracks_sharded(jnp.asarray(log_B), jnp.asarray(log_pi),
                                     jnp.asarray(log_obs), jax_make_mesh(data=8, seq=1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, o in zip(got.numpy(), obs):
        np.testing.assert_array_equal(g, viterbi_oracle(transition_matrix=A, prob_init=pi, probs_st=o))


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_decode_batch_mesh_matches_unsharded_and_jax(rng, kind):
    """viterbi_decode_batch(mesh=) over 8 CPU blocks, 10 ragged tracks (not
    a multiple of 8), equal to the unsharded decode and to JAX's
    viterbi_decode_batch_pallas(mesh=) on its 8 devices; the banded
    dispatch for a shaped matrix, the dense one for a random matrix."""
    A, pi, _ = realistic_hmm(rng)
    if kind == "dense":
        A, pi, _ = random_hmm(rng, A.shape[0], 4)
    S = A.shape[0]
    tracks = []
    for i in range(10):
        T = 40 + 17 * i
        path = np.clip(30 + np.cumsum(rng.integers(-1, 2, T)), 0, S - 2)
        obs = np.full((S, T), 1e-4, np.float32)
        obs[path, np.arange(T)] = 1.0
        tracks.append(obs / obs.sum(0, keepdims=True))
    kw = dict(transition_matrix=A, prob_init=pi, probs_st_list=tracks)
    single = TVD.viterbi_decode_batch(**kw, device="cpu")
    sharded = TVD.viterbi_decode_batch(**kw, device="cpu", mesh=make_mesh(data=8, devices=CPU8))
    jax_sharded = viterbi_decode_batch_pallas(**kw, block_frames=32,
                                              mesh=jax_make_mesh(data=8, seq=1))
    for s, m, j in zip(single, sharded, jax_sharded):
        np.testing.assert_array_equal(m, s)
        np.testing.assert_array_equal(m, j)


def test_fused_and_logobs_mesh_match_unsharded(rng):
    """viterbi_decode_batch_fused_obs(mesh=) and
    viterbi_decode_batch_logobs(mesh=) over 3 CPU blocks equal the
    unsharded calls on 5 ragged tracks, shaped and dense matrices."""
    lengths = np.array([32, 27, 31, 7, 19], np.int32)
    lg = torch.from_numpy(OF.contract_logits(rng, 5, 32, 60))
    mesh = make_mesh(data=3, devices=["cpu"] * 3)
    shaped, spi, _ = realistic_hmm(rng)
    dense, dpi, _ = random_hmm(rng, 61, 4)
    for A, pi in ((shaped, spi), (dense, dpi)):
        obs = dict(method="shaun", spw=3, threshold_logit=0.3)
        kw = dict(transition_matrix=A, prob_init=pi, logits=lg, lengths=lengths, obs=obs)
        one = TVD.viterbi_decode_batch_fused_obs(**kw).numpy()
        got = TVD.viterbi_decode_batch_fused_obs(**kw, mesh=mesh).numpy()
        log_obs = OF.log_obs(lg, obs)
        kw = dict(transition_matrix=A, prob_init=pi, log_obs=log_obs, lengths=lengths)
        got_log = TVD.viterbi_decode_batch_logobs(**kw, mesh=mesh).numpy()
        for n, L in enumerate(lengths):
            np.testing.assert_array_equal(got[n, :L], one[n, :L])
            np.testing.assert_array_equal(got_log[n, :L], one[n, :L])


@pytest.mark.parametrize("fused", [False, True])
def test_decoder_setup_mesh_matches_jax(rng, fused):
    """DecoderSetup(mesh=) on 2 CPU blocks, through from_numpy with the
    JAX setup's fields, equals the JAX DecoderSetup with its 2-device mesh;
    a mesh that is not the port's raises."""
    js = dataclasses.replace(_jax_setup("dense", "shaun", rng), fused_obs=fused,
                             mesh=jax_make_mesh(data=2, seq=1))
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    with pytest.raises(ValueError, match="mesh"):
        TE.DecoderSetup.from_numpy(fields, device="cpu")
    ts = TE.DecoderSetup.from_numpy(dict(fields, mesh=make_mesh(data=2, devices=["cpu"] * 2)),
                                    device="cpu")
    assert ts.mesh.shape == {"data": 2, "seq": 1} and ts.fused_obs == fused
    logits = [_logits(rng, js.n_bins, L) for L in (70, 45, 9)]
    for (jv, jb), (tv, tb) in zip(js.decode_batch(logits), ts.decode_batch(logits)):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tb, jb)


def test_decode_cli_mesh_matches_jax(tmp_path, rng):
    """The port's CLI with --device cpu --mesh data=2 writes the JAX CLI's
    --mesh data=2 files (voiced and bins equal, frequencies as in
    test_torch_decode.py); without CUDA, --mesh on the default device
    exits."""
    paths = _cli_inputs(tmp_path, rng)
    common = [str(p) for p in paths] + [
        "--family", "tonet", "--artifacts", str(tmp_path / "hmm"), "--format", "npz",
        "--mesh", "data=2",
    ]
    got = TD.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    want = JD.main(common + ["--out", str(tmp_path / "j")])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["voiced"], w["voiced"])
        np.testing.assert_array_equal(g["bins"], w["bins"])
    for p in paths:
        t, j = np.load(tmp_path / "t" / f"{p.stem}.npz"), np.load(tmp_path / "j" / f"{p.stem}.npz")
        np.testing.assert_array_equal(t["bins"], j["bins"])
        np.testing.assert_allclose(t["freqs"], j["freqs"], rtol=1e-6, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA devices"):
            TD.main(common + ["--out", str(tmp_path / "c")])
