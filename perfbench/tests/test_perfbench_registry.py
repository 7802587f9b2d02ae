"""BENCHMARK.json against the form its readers expect, and every piece of every
cell found by name from data."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in BENCH[group]:
            extra = set(e) - keys
            assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set()), e
            assert NAME.match(e["name"]), e["name"]
            if group in ("end_to_end", "per_layer"):
                assert (group, e["name"]) not in names
                names.add((group, e["name"]))
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_cell_is_found_by_name():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = harness.Cell(ROOT, w["name"])
        assert callable(cell.driver_class())
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer(), w["name"]
        assert cell.limits


def test_every_metric_has_a_reader_and_every_config_its_file():
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
        for w in m.get("workloads", []):
            moves = {x["name"] for x in harness.Cell(ROOT, w).end_to_end()}
            assert m["moves"] in moves
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["file"].startswith("perfbench/")
        assert set(c["reduced"]) == set(cfg["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_unknown_workload_names_the_cells():
    with pytest.raises(SystemExit, match="BENCHMARK.json has"):
        harness.Cell(ROOT, "no.such.cell")


def test_judge_needs_every_limited_number_within_its_limit():
    assert harness.judge({"a": 0.0, "b": 1.0}, {"a": 0.1, "b": 1.0})
    assert not harness.judge({"a": 0.2}, {"a": 0.1})
    assert not harness.judge({}, {"a": 0.1})
    assert not harness.judge({"a": float("nan")}, {"a": 0.1})
    assert not harness.judge({"a": 0.0}, {})


def test_a_metric_without_a_file_of_its_own_is_read_by_its_stem():
    shared = harness.load_reader("idle_share.any_later_kind")
    assert shared.__module__ == "perfbench.metrics.idle_share"
    with pytest.raises(FileNotFoundError):
        harness.load_reader("no_such_metric.decode")
