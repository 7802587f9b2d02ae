"""Whole runs of cells defined only by data (tests/tiny.py) on the CPU:
the result line, the look for a card, the control failing, and the timed
path broken underneath making `correct` false."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import calibrate, run
from perfbench.tests.tiny import write_root

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return write_root(tmp_path_factory.mktemp("root"))


def run_cell(root, cell, capsys, trace=0, seed=4294967311):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_defined_only_by_data_prints_the_result_line(root, capsys, trace):
    line, err = run_cell(root, "tiny.decode", capsys, trace)
    assert list(line)[: len(KEYS)] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        want = {m["name"] for m in bench["per_layer"] if "tiny.decode" in m["workloads"]}
        assert set(line["metrics"]) <= want and "decode_mfu" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"decode_rate", "setup_s"}
    assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "idle_share.decode")
    assert err.strip().splitlines()[-1].startswith("check path_gap ")


def test_without_a_card_the_run_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "tonet.decode", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 CUDA card" in err


def test_a_checkout_without_the_program_fails(tmp_path):
    (tmp_path / "perfbench").symlink_to(REPO / "perfbench")
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tonet.decode", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.transcribe"])
def test_the_control_fails_the_comparison(root, cell):
    rows = calibrate.main(["--workload", cell, "--seeds", "4294967329,4294967357",
                           "--seconds", "0.2"], root=root, device="cpu")
    limits = rows[0]["limits"]
    for r in rows:
        over = [k for k, v in r["numbers"].items() if v > limits[k]]
        assert bool(over) == (r["kind"] == "control"), r


def altered(fn):
    """A decode entry whose answer is altered where it is produced: one state
    of the first track moved by a third of the states."""
    def wrapper(*args, **kwargs):
        states = fn(*args, **kwargs)
        S = kwargs["transition_matrix"].shape[0]
        states[0, 1] = (states[0, 1] + S // 3) % S
        return states
    return wrapper


def test_an_altered_decode_answer_is_not_correct(root, capsys, monkeypatch):
    from viterbi_spl_tpu_torch.hmm import viterbi_dense

    monkeypatch.setattr(viterbi_dense, "viterbi_decode_batch_fused_obs",
                        altered(viterbi_dense.viterbi_decode_batch_fused_obs))
    line, _ = run_cell(root, "tiny.decode", capsys)
    assert line["correct"] is False


def test_an_altered_transcription_is_not_correct(root, capsys, monkeypatch):
    from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup

    decode = DecoderSetup.decode_batch

    def wrong(self, logits_list):
        out = decode(self, logits_list)
        voiced, bins = out[0]
        bins = bins.copy()
        bins[len(bins) // 2] = (bins[len(bins) // 2] + 120) % self.n_bins
        return [(voiced | True, bins)] + out[1:]

    monkeypatch.setattr(DecoderSetup, "decode_batch", wrong)
    line, _ = run_cell(root, "tiny.transcribe", capsys)
    assert line["correct"] is False


def test_a_transcription_is_correct(root, capsys):
    line, _ = run_cell(root, "tiny.transcribe", capsys)
    assert line["correct"] is True and set(line["metrics"]) == {"transcribe_rate", "setup_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["jdc.decode", "tonet.decode", "tonet.transcribe"])
def test_each_cell_runs_correct_on_the_card(cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc = run.main(["--workload", cell, "--seed", str(np.uint32(2 ** 31 + 11)), "--seconds", "3",
                   "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["correct"] is True
