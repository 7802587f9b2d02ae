"""The jdc.transcribe cell on the CPU: a whole run of the cell at short clips
(its configuration and traffic file, the pool and the lengths cut), its
readers on known values and on a program without the cell's spans, and the
reference's count of a frame's work."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.drivers.transcribe_jdc import jdc_flops_per_frame
from perfbench.harness import load_reader

REPO = Path(__file__).resolve().parents[2]
CELL = "jdc.transcribe"
NEW = ["conv_share.transcribe_jdc", "recurrent_share.transcribe_jdc"]
# every per-layer metric the cell reports: its own two and the transcription
# metrics it shares with tonet.transcribe
METRICS = [m["name"] for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
           if CELL in m.get("workloads", ())]
# the readers of the program's spans, None on a program without them
SPAN_READERS = NEW + ["model_idle_share.transcribe", "front_end_idle_share.transcribe",
                      "decode_idle_share.transcribe", "host_waits.transcribe",
                      "copied_mb.transcribe"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root holding the cell alone, its clips 60-100 frames, a pool
    of 3 and a check of 2."""
    torch.set_num_threads(4)
    tmp = tmp_path_factory.mktemp("jdc_root")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] == CELL]
    bench["configs"] = [c for c in bench["configs"] if c["name"] == "jdc_crnn"]
    traffic = json.loads((REPO / "perfbench" / "traffic" / "transcribe_jdc.json").read_text())
    traffic.update(pool_tracks=3, lengths={"min": 60, "mode": 80, "max": 100, "length_seed": 7},
                   check={"tracks": 2})
    for sub, name, data in (("configs", "jdc_crnn", None), ("traffic", "transcribe_jdc", traffic),
                            ("limits", CELL, None)):
        (tmp / "perfbench" / sub).mkdir(parents=True)
        text = (REPO / "perfbench" / sub / f"{name}.json").read_text() if data is None else \
            json.dumps(data)
        (tmp / "perfbench" / sub / f"{name}.json").write_text(text)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_cpu(root, capsys, trace):
    rc = run.main(["--workload", CELL, "--seed", "4294967311", "--seconds", "0.5", "--trace",
                   str(trace)], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == {"logit_gap", "path_gap"}
    if trace:
        # on the CPU no copy reaches a card: host_waits and copied_mb have
        # nothing to count
        assert set(line["metrics"]) == set(METRICS) - {"host_waits.transcribe",
                                                       "copied_mb.transcribe"}
        assert line["metrics"]["transcribe_mfu"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"transcribe_rate", "setup_s"}


def record(name, start, end, **attrs):
    from viterbi_spl_tpu_torch import tracing

    return tracing.Record(name, 0, None, 1, start, end, attrs, {})


def test_the_launched_shares_read_the_device_time_launched_in_their_spans(monkeypatch):
    from viterbi_spl_tpu_torch import tracing

    spans = [record("model.convs", 100, 200), record("model.recurrent", 300, 400, head="pitch"),
             record("model.recurrent", 500, 600, head="voicing")]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)

    def launched_in(pairs):
        return {((100, 200),): 0.25, ((300, 400), (500, 600)): 0.05}[tuple(sorted(pairs))]

    trace = types.SimpleNamespace(start=0, end=1000, window_s=5.0, launched_in=launched_in)
    run_ = types.SimpleNamespace(trace=trace, records=[{}])
    assert load_reader("conv_share.transcribe_jdc")(run_) == pytest.approx(5.0)
    assert load_reader("recurrent_share.transcribe_jdc")(run_) == pytest.approx(1.0)
    # a program without the cell's spans, as the parent checkout is
    spans[:] = [record("model", 100, 600)]
    assert load_reader("conv_share.transcribe_jdc")(run_) is None
    assert load_reader("recurrent_share.transcribe_jdc")(run_) is None
    monkeypatch.setitem(sys.modules, "viterbi_spl_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["viterbi_spl_tpu_torch"], "tracing")
    assert all(load_reader(m)(run_) is None for m in SPAN_READERS)


def test_a_frames_work_is_the_convs_the_dense_layers_and_the_lstms():
    """152.8 MFLOP of convolutions, 0.74 of dense layers (torch's FLOP
    counter over the program's model) and the BiLSTMs' matrix products,
    2 directions x 2 x 4 H (D + H) a frame: 3.42 MFLOP, 1.06 of them the
    recurrent W_hh h."""
    lstm = 2 * 2 * 4 * (256 * (512 + 256) + 32 * (512 + 32))
    got = jdc_flops_per_frame(722, 31, 513)
    assert got == pytest.approx(152.8e6 + 0.74e6 + lstm, rel=0.01)


def test_an_altered_transcription_is_not_correct(root, capsys, monkeypatch):
    """One frame's bin moved by 120: the random model's paths hold one bin a
    clip, and the check still sees a path off the reference's best."""
    from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup

    decode = DecoderSetup.decode_batch

    def wrong(self, logits_list):
        out = decode(self, logits_list)
        voiced, bins = out[0]
        bins = bins.copy()
        bins[len(bins) // 2] = (bins[len(bins) // 2] + 120) % self.n_bins
        return [(voiced, bins)] + out[1:]

    monkeypatch.setattr(DecoderSetup, "decode_batch", wrong)
    rc = run.main(["--workload", CELL, "--seed", "4294967311", "--seconds", "0.5", "--trace", "0"],
                  root=root, device="cpu")
    line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False and line["checks"]["path_gap"]["value"] > 1e-4
