"""The readers of the metrics built on the program's own spans
(perfbench/metrics/_program.py and the files that use it): known values on
a synthetic run, None where the program has no tracer, no span or dropped
spans, and the tiny cells' traced CPU runs reporting them or leaving them
out without error."""

from __future__ import annotations

import json
import sys
import types

import pytest

from perfbench.harness import load_reader
from perfbench.tests.test_perfbench_runs import root, run_cell  # noqa: F401 (fixture)

NEW = {"prepare_ms.decode", "wait_ms.decode", "api_idle_share.decode", "tables_built.decode",
       "front_end_idle_share.transcribe", "model_idle_share.transcribe",
       "decode_idle_share.transcribe", "host_waits.transcribe", "copied_mb.transcribe"}


def span(name, start, end, request, **counts):
    from viterbi_spl_tpu_torch import tracing

    return tracing.Record(name, 0, None, request, start, end, {}, counts)


@pytest.fixture
def synthetic(monkeypatch):
    """A window of 1,000 ns with the card busy over [100, 200] and
    [500, 600], two requests (clips), and one span before the window."""
    from viterbi_spl_tpu_torch import tracing

    spans = [
        span("decode", -10, 40, 9),
        span("decode.prepare", 60, 160, 1, tables_built=1), span("decode.wait", 300, 350, 1, host_waits=1,
                                                  h2d_bytes=2_000_000),
        span("decode", 50, 450, 1),
        span("decode.prepare", 490, 530, 2), span("decode", 480, 900, 2),
    ]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    trace = types.SimpleNamespace(start=0, end=1000, busy=[[100, 200], [500, 600]])
    return types.SimpleNamespace(trace=trace, records=[{}, {}]), spans


def test_each_reader_gives_its_known_value(synthetic):
    run, spans = synthetic
    assert load_reader("prepare_ms.decode")(run) == pytest.approx(140 / 1e6 / 2)
    assert load_reader("wait_ms.decode")(run) == pytest.approx(50 / 1e6 / 2)
    assert load_reader("tables_built.decode")(run) == pytest.approx(0.5)
    # decode spans cover 820 ns of the window, 200 of them busy
    assert load_reader("api_idle_share.decode")(run) == pytest.approx(62.0)
    assert load_reader("host_waits.transcribe")(run) == pytest.approx(0.5)
    assert load_reader("copied_mb.transcribe")(run) == pytest.approx(1.0)
    layers = {"front_end": "front_end", "model": "model", "decode": "decode_service"}
    assert all(load_reader(f"{m}_idle_share.transcribe")(run) is None for m in layers)
    spans += [span(name, 150, 550, 3) for name in layers.values()]
    for m in layers:
        # [150, 550]: 400 ns, of which [150, 200] and [500, 550] busy
        assert load_reader(f"{m}_idle_share.transcribe")(run) == pytest.approx(30.0)


def test_no_tracer_no_span_or_dropped_spans_give_none(synthetic, monkeypatch):
    from viterbi_spl_tpu_torch import tracing

    run, spans = synthetic
    assert load_reader("prepare_ms.decode")(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    assert all(load_reader(m)(run) is None for m in NEW)
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    # a program without the tracer, as the parent checkout is
    monkeypatch.delattr(sys.modules["viterbi_spl_tpu_torch"], "tracing")
    monkeypatch.setitem(sys.modules, "viterbi_spl_tpu_torch.tracing", None)
    assert all(load_reader(m)(run) is None for m in NEW)


def test_a_window_without_the_programs_spans_gives_none(synthetic):
    run, spans = synthetic
    spans.clear()
    assert all(load_reader(m)(run) is None for m in NEW)


@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.transcribe"])
def test_the_tiny_cells_traced_runs_report_them_or_leave_them_out(root, capsys, cell):  # noqa: F811
    line, _ = run_cell(root, cell, capsys, trace=1)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]} & NEW
    got = set(line["metrics"]) & NEW
    assert got <= mine and line["correct"] is True
    # on the CPU the program's spans time the decode's tables, and no copy
    # reaches a card
    if cell == "tiny.decode":
        assert {"prepare_ms.decode", "api_idle_share.decode", "tables_built.decode"} <= got
        assert line["metrics"]["tables_built.decode"]["value"] == 1.0
    else:
        assert {"front_end_idle_share.transcribe", "model_idle_share.transcribe",
                "decode_idle_share.transcribe"} <= got
    assert not got & {"wait_ms.decode", "host_waits.transcribe", "copied_mb.transcribe"}
    assert all(line["metrics"][m]["value"] >= 0 for m in got)
