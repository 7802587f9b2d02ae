"""The port's tracer (viterbi_spl_tpu_torch/tracing.py), on the CPU.

- Off (no profiler), a span records nothing and enters no
  record_function; enabled(False) keeps it off under a profiler.
- On, under torch.profiler with CPU activity: nested spans carry the
  request and parent ids, a root span its kernel launches; a span around a
  torch op contains the op's kineto start, so both lie on one clock;
  counters go to the innermost span; request() makes root spans share an
  id; DecoderSetup.decode_batch yields decode_service, decode and
  decode.prepare (tables_reused 1, tables_built 0: the setup's prepared
  HMM), and its states equal the untraced ones.
- No span synchronises: with torch.cuda.synchronize raising, a traced
  decode runs.
- The buffer keeps CAPACITY spans and counts the rest as dropped.
- utils.profile_trace's Chrome trace names the program's spans.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch import tracing
from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup
from viterbi_spl_tpu_torch.hmm import viterbi_dense
from viterbi_spl_tpu_torch.utils import profile_trace


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def banded_setup(n_bins=24, d_max=3):
    """A DecoderSetup on the CPU whose matrix has the banded structure
    with source-profile classes (K1/K2's path)."""
    S = n_bins + 1
    A = np.zeros((S, S), np.float32)
    for i in range(n_bins):
        for j in range(max(0, i - d_max), min(n_bins, i + d_max + 1)):
            A[i, j] = 1.0 / (1 + abs(i - j))
    A[:n_bins, :n_bins] *= 0.9 / A[:n_bins, :n_bins].sum(axis=1, keepdims=True)
    A[:n_bins, n_bins] = 0.1
    A[n_bins, :n_bins] = 0.2 / n_bins
    A[n_bins, n_bins] = 0.8
    pi = np.full(S, 1.0 / S, np.float32)
    return DecoderSetup(transition_matrix=A, init_probs=pi, n_bins=n_bins, note_min=0.0,
                        bins_per_semitone=1.0, spw=2, voicing_threshold=0.5, hop_seconds=0.01,
                        device="cpu")


def test_off_a_span_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(tracing, "_annotation", refuse)
    assert not tracing.recording()
    with tracing.span("a", x=1) as sp:
        tracing.count("host_waits")
        with tracing.wait("a"):
            pass
    assert not sp and tracing.span("b") is sp
    assert tracing.spans() == [] and tracing.dropped() == 0
    monkeypatch.undo()
    with cpu_profile(), tracing.enabled(False):
        with tracing.span("c"):
            pass
    assert tracing.spans() == []


def test_nested_spans_carry_request_parent_and_launches():
    with cpu_profile():
        with tracing.span("outer", k=1):
            viterbi_dense.banded_forward.launches += 1
            with tracing.span("inner"):
                with tracing.span("innermost"):
                    pass
            viterbi_dense.banded_forward.launches -= 1
            viterbi_dense.banded_backtrace.launches += 2
        with tracing.span("next"):
            pass
        with tracing.request() as rid:
            for name in ("first", "second"):
                with tracing.span(name):
                    pass
    by = {s.name: s for s in tracing.spans()}
    outer, inner, innermost = by["outer"], by["inner"], by["innermost"]
    assert outer.parent is None and inner.parent == outer.id and innermost.parent == inner.id
    assert outer.request == inner.request == innermost.request != by["next"].request
    assert by["first"].request == by["second"].request == rid != outer.request
    assert outer.start <= inner.start <= innermost.start <= innermost.end <= inner.end <= outer.end
    assert outer.attrs == {"k": 1, "launches": {"K2": 2}}
    assert "launches" not in inner.attrs and by["next"].attrs == {"launches": {}}
    viterbi_dense.banded_backtrace.launches -= 2


def test_a_span_contains_its_ops_kineto_start_and_counters_go_innermost():
    x = torch.ones(256, 256)
    with cpu_profile() as prof:
        with tracing.span("op") as sp:
            y = x @ x
            tracing.count("h2d_bytes", 8)
            with tracing.wait("layer"):
                tracing.count("d2h_bytes", 4)
            tracing.count("h2d_bytes", 2)
    assert float(y[0, 0]) == 256.0
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm and all(sp.start <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end
                      for e in mm)
    wait = next(s for s in tracing.spans() if s.name == "layer.wait")
    assert sp.counts == {"h2d_bytes": 10}
    assert wait.counts == {"host_waits": 1, "d2h_bytes": 4} and wait.parent == sp.id
    assert "op" in {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("fused_obs", [False, True])
def test_decode_batch_yields_the_decode_spans(monkeypatch, fused_obs):
    setup = banded_setup()
    setup.fused_obs = fused_obs
    rng = np.random.default_rng(3)
    logits = [rng.normal(size=(T, setup.n_bins)).astype(np.float32) for T in (31, 17)]
    untraced = setup.decode_batch(logits)

    def refuse(*args, **kwargs):
        raise AssertionError("a span synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with cpu_profile():
        traced = setup.decode_batch(logits)
    for (v0, b0), (v1, b1) in zip(untraced, traced):
        np.testing.assert_array_equal(v0, v1)
        np.testing.assert_array_equal(b0, b1)
    spans = tracing.spans()
    names = [s.name for s in spans]
    assert {"decode_service", "decode_service.observe", "decode", "decode.prepare",
            "decode.forward", "decode.route", "decode.backtrace"} <= set(names)
    assert len({s.request for s in spans}) == 1
    # the untraced call above found the setup's prepared HMM, as this one does
    assert sum(s.counts.get("tables_built", 0) for s in spans) == 0
    assert sum(s.counts.get("tables_reused", 0) for s in spans) == 1
    root = next(s for s in spans if s.parent is None)
    assert root.name == "decode_service" and root.attrs == {"launches": {}}
    api = [s for s in spans if s.name == "decode" and "route" in s.attrs]
    assert len(api) == 1 and api[0].attrs == {"tracks": 2, "frames": 48, "states": 25,
                                              "route": "plain"}


def test_the_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.enabled():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s0", "s1", "s2"] and tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_profile_trace_names_the_programs_spans(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        with tracing.span("front_end"):
            with tracing.span("front_end.blocks"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"front_end", "front_end.blocks"} <= names
    assert [s.name for s in tracing.spans()] == ["front_end.blocks", "front_end"]
