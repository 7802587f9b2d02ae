"""The port's runtime utilities (viterbi_spl_tpu_torch/utils.py) against the
JAX package's (viterbi_spl_tpu/utils.py), on the CPU; the templates are
tests/test_bucketing.py (the bucket grid) and tests/test_threshold_utils.py
(Timer, configure_logging, device_summary).

- shape_bucket equals the JAX package's on test_bucketing.py's cases and
  over a sweep of sizes, quanta, ratios and minimums, with the same errors;
- Timer accumulates spans and reports them as the JAX Timer does;
- configure_logging quiets torch's logger; device_summary names the
  device count and the process count;
- initialize_distributed is a no-op for one process, and process_count /
  process_index read 1 / 0 without a runtime;
- profile_trace writes a trace file that TensorBoard and Perfetto read.
"""

import json
import logging

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.utils import Timer as JTimer
from viterbi_spl_tpu.utils import shape_bucket as j_shape_bucket
from viterbi_spl_tpu_torch.utils import (
    Timer,
    configure_logging,
    device_summary,
    initialize_distributed,
    process_count,
    process_index,
    profile_trace,
    shape_bucket,
)


def test_shape_bucket_grid():
    """test_bucketing.py::test_shape_bucket_grid's cases."""
    assert shape_bucket(1, quantum=64) == 64
    assert shape_bucket(64, quantum=64) == 64
    assert shape_bucket(65, quantum=64) == 128
    assert shape_bucket(8, quantum=8, ratio=2.0) == 8
    assert shape_bucket(9, quantum=8, ratio=2.0) == 16
    grid = []
    for n in range(1, 100_000, 997):
        bb = shape_bucket(n, quantum=64)
        assert bb >= n and bb % 64 == 0
        grid.append(bb)
    assert len(set(grid)) <= 40
    with pytest.raises(ValueError):
        shape_bucket(0, quantum=64)
    assert shape_bucket(2, quantum=1) == 2
    assert shape_bucket(7, quantum=2) >= 7
    assert shape_bucket(1000, quantum=3) >= 1000


@pytest.mark.parametrize("quantum,ratio,minimum", [
    (64, 1.25, None), (8, 2.0, None), (1, 1.25, None), (3, 1.1, None), (128, 1.5, 256),
    (16, 1.25, 48),
])
def test_shape_bucket_equals_jax(quantum, ratio, minimum):
    for n in list(range(1, 300)) + list(range(300, 200_000, 1231)):
        assert shape_bucket(n, quantum, ratio, minimum) == \
            j_shape_bucket(n, quantum, ratio, minimum), (n, quantum, ratio, minimum)


def test_timer_matches_jax_timer(monkeypatch):
    """The same spans under a stepped clock give the same totals, counts and
    report. The JAX Timer reads time.perf_counter, the port's (tracing.timed
    spans) time.time_ns."""
    import viterbi_spl_tpu.utils as ju
    import viterbi_spl_tpu_torch.tracing as tt

    reports = []
    for mod, clock, unit, cls in ((ju, "perf_counter", 1, JTimer), (tt, "time_ns", 10**9, Timer)):
        ticks = iter(np.arange(100) * 0.25)
        monkeypatch.setattr(mod.time, clock, lambda: float(next(ticks)) * unit)
        t = cls()
        for name in ("a", "b", "a"):
            with t.span(name):
                pass
        assert t.counts == {"a": 2, "b": 1} and t.totals["a"] == 0.5
        reports.append(t.report())
        monkeypatch.undo()
    assert reports[0] == reports[1] and "a:" in reports[1]


def test_logging_and_device_summary():
    logging.getLogger("torch").setLevel(logging.DEBUG)
    configure_logging()
    assert logging.getLogger("torch").level == logging.WARNING
    summary = device_summary()
    assert "device" in summary and "1 process(es)" in summary
    assert summary.startswith("1 devices (1x cpu)") or torch.cuda.is_available()


def test_initialize_distributed_single_process_is_noop():
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert process_count() == 1 and process_index() == 0
    with pytest.raises(ValueError, match="process_id"):
        initialize_distributed("127.0.0.1:1", num_processes=2)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
