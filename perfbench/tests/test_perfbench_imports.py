"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program; nothing reads the JAX-era benchmark files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench.harness import FORBIDDEN, forbidden_modules

PACKAGE = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_in_the_benchmark(path):
    assert not imported_tops(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "viterbi_spl_tpu_torch" not in imported_tops(path)
    assert "viterbi_spl_tpu_torch" not in path.read_text()


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["viterbi_spl_tpu_torch", "viterbi_spl_tpu_torch.hmm", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["viterbi_spl_tpu", "viterbi_spl_tpu.hmm", "jax.numpy", "jaxlib",
                              "flax.linen", "optax", "orbax.checkpoint"]) == sorted(
        ["viterbi_spl_tpu", "viterbi_spl_tpu.hmm", "jax.numpy", "jaxlib", "flax.linen", "optax",
         "orbax.checkpoint"])


def test_nothing_reads_the_jax_era_benchmark_files():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        assert "chip_smoke" not in imported_tops(path)
        text = path.read_text()
        assert not any(n in text for n in ("bench.py", "BENCH_r0", "BASELINE", "MULTICHIP_r0")), path
