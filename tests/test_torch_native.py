"""The port's native CPU components (viterbi_spl_tpu_torch/native/: the C++
Viterbi core and the snippet prefetch ring, built with g++ into the port's
_build/) against the NumPy oracle and the JAX package's, on the CPU
(template: tests/test_native.py).

Tolerance: none. States are int64 paths and must be equal to the oracle's
and to the JAX package's native decoder's (first-max tie-breaking
included); the ring's batches must equal the Python pipeline's bit for bit;
the validation errors must be the JAX package's, message for message.

The JAX package's native module builds its libraries beside its sources;
here it is pointed at a copy of its sources in a temporary directory, so
that no test writes into the JAX package.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import random_hmm
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.data.registry import TrackDataset as JTrackDataset
from viterbi_spl_tpu_torch import native as TN
from viterbi_spl_tpu_torch.apps import common as TC
from viterbi_spl_tpu_torch.apps import msnet
from viterbi_spl_tpu_torch.data.registry import TrackDataset
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle
from viterbi_spl_tpu_torch.hmm.viterbi import TINY, prepare_log_params
from viterbi_spl_tpu_torch.native import prefetch as TP


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's native module, building into a temporary copy of
    its sources."""
    import viterbi_spl_tpu.native as JN
    import viterbi_spl_tpu.native.prefetch as JP

    src = tmp_path_factory.mktemp("jax_native")
    for name in ("viterbi_native.cpp", "prefetch_ring.cpp"):
        shutil.copy(JN._THIS_DIR / name, src / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_THIS_DIR", src)
        mp.setattr(JN, "_SO_PATH", src / "libviterbi_native.so")
        mp.setattr(JN, "_lib", None)
        assert JN.native_available()
        yield JN, JP


@pytest.mark.parametrize("S,T", [(17, 60), (321, 150), (722, 40)])
def test_native_matches_oracle_and_jax(rng, jnative, S, T):
    JN, _ = jnative
    A, pi, obs = random_hmm(rng, S, T)
    got = TN.viterbi_native_fn(transition_matrix=A, prob_init=pi, probs_st=obs)
    assert got.dtype == np.int64 and got.shape == (T,)
    np.testing.assert_array_equal(got, viterbi_oracle(transition_matrix=A, prob_init=pi,
                                                      probs_st=obs))
    np.testing.assert_array_equal(got, JN.viterbi_native_fn(transition_matrix=A, prob_init=pi,
                                                            probs_st=obs))


def test_native_sparse_and_ties(rng, jnative):
    JN, _ = jnative
    A, pi, obs = random_hmm(rng, 130, 90, sparse_obs=True)
    got = TN.viterbi_native_fn(transition_matrix=A, prob_init=pi, probs_st=obs)
    np.testing.assert_array_equal(got, viterbi_oracle(transition_matrix=A, prob_init=pi,
                                                      probs_st=obs))
    np.testing.assert_array_equal(got, JN.viterbi_native_fn(transition_matrix=A, prob_init=pi,
                                                            probs_st=obs))
    # exact ties at every step: the lowest index
    kw = dict(transition_matrix=np.full((4, 4), 0.25, np.float32), prob_init=np.full(4, 0.25),
              probs_st=np.full((4, 8), 0.25, np.float32))
    np.testing.assert_array_equal(TN.viterbi_native_fn(**kw), np.zeros(8, np.int64))
    np.testing.assert_array_equal(TN.viterbi_native_fn(**kw), JN.viterbi_native_fn(**kw))


def test_native_log_domain_matches(rng, jnative):
    JN, _ = jnative
    A, pi, obs = random_hmm(rng, 75, 100)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = np.log(obs.T + TINY)
    got = TN.viterbi_native_log_fn(log_B, log_pi, log_obs)
    np.testing.assert_array_equal(got, viterbi_oracle(transition_matrix=A, prob_init=pi,
                                                      probs_st=obs))
    np.testing.assert_array_equal(got, JN.viterbi_native_log_fn(log_B, log_pi, log_obs))


def test_native_backtrace(rng, jnative):
    JN, _ = jnative
    T, S = 200, 50
    T2 = rng.integers(0, S, (T, S)).astype(np.int32)
    s, want = 7, np.empty(T, np.int64)
    want[-1] = s
    for t in range(T - 2, -1, -1):
        s = T2[t + 1, s]
        want[t] = s
    got = TN.backtrace_native(T2, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JN.backtrace_native(T2, 7))
    for fn in (TN.backtrace_native, JN.backtrace_native):
        with pytest.raises(RuntimeError, match="backtrace failed with code -1"):
            fn(T2, S)


@pytest.mark.parametrize("case", ["rows", "init", "shape"])
def test_native_validation_errors(jnative, case):
    JN, _ = jnative
    A = np.full((3, 3), 1 / 3, np.float32)
    pi, obs = np.full(3, 1 / 3), np.full((3, 5), 1 / 3, np.float32)
    if case == "rows":
        A = np.full((3, 3), 0.5, np.float32)  # rows sum to 1.5
    elif case == "init":
        pi = np.full(3, 0.5)
    else:
        obs = np.full((4, 5), 0.25, np.float32)
    messages = []
    for fn in (TN.viterbi_native_fn, JN.viterbi_native_fn):
        with pytest.raises(ValueError) as e:
            fn(transition_matrix=A, prob_init=pi, probs_st=obs)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_native_builds_into_the_port(jnative):
    """The port's libraries are its own: built from its copies of the
    sources (the JAX package's code, comments aside) into its _build/
    directory, named by a hash of source and flags."""
    JN, _ = jnative

    def code(path):
        return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]

    for source in ("viterbi_native.cpp", "prefetch_ring.cpp"):
        path = TN.build_native(source)
        assert path == TN.library_path(source) and path.exists()
        assert path.parent == TN.BUILD_DIR and path.name.startswith(f"lib{source[:-4]}-")
        assert code(TN._THIS_DIR / source) == code(JN._THIS_DIR / source)


def _datasets(rng):
    frames = [70, 45, 101]
    specs = {f"t{i}": rng.normal(size=(f, 12, 2)).astype(np.float32) for i, f in enumerate(frames)}
    notes = {f"t{i}": rng.normal(size=f).astype(np.float32) for i, f in enumerate(frames)}

    def label(t):
        return dict(notes=notes[t], original=dict(times=np.arange(len(notes[t])) * 0.01,
                                                  freqs=np.abs(notes[t])))

    return (TrackDataset(list(specs), lambda t: specs[t], label),
            JTrackDataset(list(specs), lambda t: specs[t], label))


@pytest.mark.parametrize("zero_copy", [False, True])
def test_prefetch_ring_matches_python_pipeline_and_jax(rng, jnative, zero_copy):
    """The ring yields the exact batches of the port's and the JAX
    package's Python references for the same seed, across epoch boundaries
    (the index holds 8 full snippets, a batch 3) and slot reuse (3 slots,
    12 batches)."""
    _, JP = jnative
    ds, jds = _datasets(rng)
    pf = TP.SnippetPrefetcher(ds, snippet_len=20, batch_size=3, rng=np.random.default_rng(7),
                              slots=3, threads=2, zero_copy=zero_copy)
    jpf = JP.SnippetPrefetcher(jds, snippet_len=20, batch_size=3, rng=np.random.default_rng(7),
                               slots=3, threads=2)
    ref = pf.python_reference_batches(np.random.default_rng(7))
    jref = jpf.python_reference_batches(np.random.default_rng(7))
    it = iter(pf)
    for _ in range(12):
        spec, notes = next(it)
        assert spec.shape == (3, 20, 12, 2) and notes.shape == (3, 20)
        assert spec.flags.owndata != zero_copy
        for rs, rn in (next(ref), next(jref)):
            np.testing.assert_array_equal(spec, rs)
            np.testing.assert_array_equal(notes, rn)
    pf.close()
    jpf.close()


def test_training_batches_native_prefetch(rng, monkeypatch, capsys):
    """training_batches(native_prefetch=True): the ring's batches as
    tensors; the Python pipeline, with the JAX app's message, only where
    the dataset has no full-length snippet; a ring that fails to build
    raises."""
    ds, _ = _datasets(rng)
    cfg = dataclasses.replace(msnet.config(), snippet_len=20, batch_size=3)
    ring = TC.training_batches(cfg, ds, np.random.default_rng(5), "cpu", native_prefetch=True)
    ref = TP.SnippetPrefetcher(ds, 20, 3, np.random.default_rng(5)).python_reference_batches(
        np.random.default_rng(5))
    for _ in range(5):
        (spec, notes), (rs, rn) = next(ring), next(ref)
        assert isinstance(spec, torch.Tensor) and spec.device.type == "cpu"
        np.testing.assert_array_equal(spec.numpy(), rs)
        np.testing.assert_array_equal(notes.numpy(), rn)

    long = dataclasses.replace(cfg, snippet_len=200)
    got = TC.training_batches(long, ds, np.random.default_rng(5), "cpu", native_prefetch=True)
    assert "native prefetch unavailable (no full-length snippets in dataset); using the " \
           "Python pipeline" in capsys.readouterr().out
    want = TC.training_batches(long, ds, np.random.default_rng(5), "cpu")
    for _ in range(4):
        for a, b in zip(next(got), next(want)):
            assert torch.equal(a, b)

    def broken(source):
        raise RuntimeError(f"g++ failed for {source}")

    monkeypatch.setattr(TP, "build_native", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TC.training_batches(cfg, ds, np.random.default_rng(5), "cpu", native_prefetch=True)


def test_msnet_train_native_prefetch_same_losses(tmp_path, monkeypatch, capsys):
    """`msnet train --native-prefetch --device cpu` gives the losses of the
    Python pipeline, epoch for epoch, where every snippet is full length
    (snippets of 200 frames over the 400-frame --debug tracks: both streams
    draw the same permutations)."""
    wide = msnet.config
    monkeypatch.setattr(msnet, "config", lambda: dataclasses.replace(wide(), snippet_len=200))
    losses = {}
    for name, extra in (("python", []), ("ring", ["--native-prefetch"])):
        log = tmp_path / name
        msnet.main(["train", "--synthetic", "--debug", "--device", "cpu", "--ckpt",
                    str(tmp_path / f"{name}.pt"), "--epochs", "2", "--steps-per-epoch", "3",
                    "--patience", "5", "--log-dir", str(log), *extra])
        events = [json.loads(ln) for ln in (log / "events.jsonl").read_text().splitlines()]
        losses[name] = [e["value"] for e in events if e.get("tag") == "train_loss"]
    assert "native prefetch unavailable" not in capsys.readouterr().out
    assert len(losses["ring"]) == 2 and losses["ring"] == losses["python"]
