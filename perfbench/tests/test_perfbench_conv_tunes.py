"""conv_tunes.transcribe_jdc: its reader on known values and on a program
without the counter, and a whole run of jdc.transcribe on the CPU, whose
window meets no conv shape that set-up did not."""

from __future__ import annotations

import json
import types

import pytest

from perfbench import run
from perfbench.harness import load_reader
from perfbench.tests.test_perfbench_jdc import CELL, root  # noqa: F401 (fixture)


def test_conv_tunes_reads_the_programs_counter_a_request(monkeypatch):
    from viterbi_spl_tpu_torch import tracing

    def counted(name, request, n):
        return tracing.Record(name, 0, None, request, 150, 160, {}, {"conv_tunes": n} if n else {})

    spans = [counted("model.convs", 1, 1), counted("model.convs", 2, 0), counted("model", 2, 0),
             counted("model.convs", 3, 0), counted("model.convs", 4, 2)]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    run_ = types.SimpleNamespace(trace=types.SimpleNamespace(start=100, end=200), records=[{}])
    read = load_reader("conv_tunes.transcribe_jdc")
    assert read(run_) == pytest.approx(3 / 4)
    spans[:] = [counted("model.convs", r, 0) for r in (1, 2, 3)]
    assert read(run_) == 0
    # a program whose tracer has no conv_tunes counter, as the parent checkout
    monkeypatch.setattr(tracing, "COUNTERS", tuple(c for c in tracing.COUNTERS
                                                   if c != "conv_tunes"))
    assert read(run_) is None
    monkeypatch.delattr(tracing, "COUNTERS")
    assert read(run_) is None


def test_the_window_meets_no_new_conv_shape(root, capsys):  # noqa: F811
    rc = run.main(["--workload", CELL, "--seed", "4294967311", "--seconds", "0.5", "--trace", "1"],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    # set-up met every chunk batch the window runs
    assert line["metrics"]["conv_tunes.transcribe_jdc"]["value"] == 0
