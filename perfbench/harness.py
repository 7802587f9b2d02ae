"""Finds a cell's pieces by name and runs it once.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name BENCHMARK.json gives it:

- BENCHMARK.json `workloads[]`: name, config, traffic, chips, why.
- the configuration: the file its `configs[]` entry names.
- the traffic mix: perfbench/traffic/<traffic>.json; its "driver" key
  names the driver, perfbench/drivers/<driver>.py (class `Driver`).
- the cell's limits on the compared numbers: perfbench/limits/<cell>.json.
- a per-layer metric: perfbench/metrics/<metric>.py (function
  `read(run)`), with any data of its own beside it as <metric>.json; a
  metric with no file of its own is read by the reader of its name's stem,
  the part before the first dot (idle_share.py reads idle_share.decode,
  idle_share.transcribe and any later idle_share.<kind>).

Data files are read under the checkout's root; driver and reader code from
this package. Adding a cell, configuration, traffic mix or metric adds
files and BENCHMARK.json entries and edits nothing here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "viterbi_spl_tpu")


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads((self.root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (self.root / "perfbench" / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads(
            (self.root / "perfbench" / "limits" / f"{name}.json").read_text())["limits"]
        self.chips = int(self.entry["chips"])

    def driver_class(self):
        return importlib.import_module(f"perfbench.drivers.{self.traffic['driver']}").Driver

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics read in this cell's traced run."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def load_reader(metric: str):
    """perfbench/metrics/<metric>.py's `read`, else that of the stem's file."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = PACKAGE / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_data(metric: str) -> dict:
    """perfbench/metrics/<metric>.json (the metric's own data)."""
    return json.loads((PACKAGE / "metrics" / f"{metric}.json").read_text())


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def judge(numbers: dict, limits: dict) -> bool:
    """Correct when every limited number is there, finite, and within its
    limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
