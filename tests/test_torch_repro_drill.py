"""The port's reproduction drill (viterbi_spl_tpu_torch/cli/repro_drill.py)
against the JAX package's (scripts/repro_drill.py, loaded as the judge as
tests/test_repro_drill.py loads it), on the CPU.

- the artifact's markdown of REPRO_r05.json's results equals the JAX
  script's line for line, but for the paragraph that names the script and
  the device;
- both mains, with run_family/run_imm replaced by REPRO_r05's rows, over the
  same pre-written corpus manifest, merge the clean regime, the hard regime
  and a separate imm call into the same JSON (but for `generated` and the
  port's device fields);
- chance_oa equals the JAX function on seeded note lists;
- one tiny end-to-end run of msnet through the port's app paths (train ->
  sweep-threshold -> infer --external-eval under the three observation
  models), with the JAX drill's checks: every corpus and method present,
  the checkpointed threshold equal to the sweep's, the cross-check exact
  where msnet's estimate grid is the corpus's timebase, and each corpus's
  chance floor equal to the JAX function's on the same tracks' notes;
- an --out of the JAX package's artifacts is refused, and no card without
  --device cpu raises.

The two --small convergence runs (clean and hard, msnet), the counterparts
of tests/test_repro_drill.py, are marked slow like their templates.
"""

import copy
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch.cli import repro_drill

REPO = Path(__file__).resolve().parent.parent
R05 = json.loads((REPO / "REPRO_r05.json").read_text())
# the port's additions to the artifact's config
PORT_CONFIG_KEYS = {"device", "nvidia_smi", "gpu_name", "power_limit"}


@pytest.fixture(scope="module")
def jax_drill():
    path = REPO / "scripts" / "repro_drill.py"
    spec = importlib.util.spec_from_file_location("repro_drill", path)
    drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drill)
    return drill


def _lines_but_first_paragraph(md: str) -> list[str]:
    lines = md.split("\n")
    assert lines[2].startswith("Generated by ")
    return lines[:2] + lines[3:]


def test_render_markdown_matches_jax_script_on_r05(jax_drill):
    args = SimpleNamespace(**{k: R05["config"][k] for k in
                              ("epochs", "patience", "steps_per_epoch", "duration")})
    want = jax_drill.render_markdown(R05, args)
    got = repro_drill.render_markdown(R05, args)
    assert _lines_but_first_paragraph(got) == _lines_but_first_paragraph(want)
    first = got.split("\n")[2]
    assert "python -m viterbi_spl_tpu_torch.cli.repro_drill" in first
    assert "scripts/repro_drill.py" not in first


def _prewritten_corpus(workdir: Path, hard: bool) -> None:
    """The manifest main() checks (at its default durations) and an env.json,
    so that no corpus is generated."""
    root = workdir / ("corpus_hard" if hard else "corpus")
    root.mkdir(parents=True)
    (root / "manifest.json").write_text(json.dumps(
        dict(duration=24.0, ext_duration=8.0, rich=True, hard=hard, version=4)))
    (root / "env.json").write_text(json.dumps({}))


def _run_three_calls(module, monkeypatch, workdir: Path, out: Path, extra=()) -> dict:
    """Clean (msnet, jdc), hard (msnet, jdc), then imm alone, each family's
    row REPRO_r05's."""
    def fake_family(name, famdir, env, args):
        assert famdir == workdir / args.regime
        return copy.deepcopy(R05["regimes"][args.regime]["families"][name])

    def fake_imm(env, args):
        return copy.deepcopy(R05["regimes"]["clean"]["families"]["imm"])

    monkeypatch.setattr(module, "run_family", fake_family)
    monkeypatch.setattr(module, "run_imm", fake_imm)
    common = ["--workdir", str(workdir), "--out", str(out), *extra]
    module.main(["--families", "msnet,jdc", *common])
    module.main(["--families", "msnet,jdc", "--regime", "hard", *common])
    module.main(["--families", "imm", *common])
    return json.loads(out.with_suffix(".json").read_text())


def test_main_merges_like_jax_script(jax_drill, tmp_path, monkeypatch):
    for hard in (False, True):
        _prewritten_corpus(tmp_path / "work", hard)
    want = _run_three_calls(jax_drill, monkeypatch, tmp_path / "work", tmp_path / "REPRO_jax")
    got = _run_three_calls(repro_drill, monkeypatch, tmp_path / "work", tmp_path / "REPRO_port",
                           extra=["--device", "cpu"])
    assert got["config"]["device"] == "cpu"
    for art in (want, got):
        art.pop("generated")
        for key in PORT_CONFIG_KEYS:
            art["config"].pop(key, None)
    assert got == want
    assert list(got["regimes"]) == ["clean", "hard"]
    assert list(got["regimes"]["clean"]["families"]) == ["msnet", "jdc", "imm"]
    md_want = (tmp_path / "REPRO_jax.md").read_text()
    md_got = (tmp_path / "REPRO_port.md").read_text()
    assert _lines_but_first_paragraph(md_got) == _lines_but_first_paragraph(md_want)


def test_chance_oa_matches_jax(jax_drill):
    rng = np.random.default_rng(13)
    for _ in range(5):
        notes = [np.where(rng.random(n) < rng.random(), 0.0, rng.uniform(30, 90, n))
                 for n in rng.integers(1, 400, rng.integers(1, 6))]
        notes[0][: 3] = 0.1  # on the voicing boundary: unvoiced
        assert repro_drill.chance_oa(notes) == jax_drill.chance_oa(notes)


def _memoized(build):
    """build(debug, device), each (debug, device) built once: every app call
    of the drill rebuilds the same tracks' features (a pure function of the
    corpus files), which tests/test_torch_drill.py and
    tests/test_torch_external.py hold already."""
    cache = {}

    def wrapper(debug=False, device=None):
        key = (debug, str(device))
        if key not in cache:
            cache[key] = build(debug=debug, device=device)
        return cache[key]

    return wrapper


def test_tiny_msnet_drill_end_to_end(jax_drill, tmp_path, monkeypatch):
    from viterbi_spl_tpu_torch.apps import msnet

    for name in ("build_real_datasets", "build_external_datasets"):
        monkeypatch.setattr(msnet, name, _memoized(getattr(msnet, name)))
    seen = []

    def chance_spy(notes_list):
        value = repro_drill_chance(notes_list)
        assert value == jax_drill.chance_oa(notes_list)
        seen.append(value)
        return value

    repro_drill_chance = repro_drill.chance_oa
    monkeypatch.setattr(repro_drill, "chance_oa", chance_spy)
    out = tmp_path / "REPRO_tiny"
    results = repro_drill.main([
        "--device", "cpu", "--families", "msnet", "--epochs", "2",
        "--steps-per-epoch", "2", "--patience", "2", "--duration", "2",
        "--ext-duration", "1", "--workdir", str(tmp_path / "work"), "--out", str(out),
    ])
    r = results["regimes"]["clean"]["families"]["msnet"]
    assert r["platform"] == "cpu" and r["epochs_run"] == 2 and r["steps_taken"] == 4
    assert 0 < r["ms_per_step"] < r["train_wall_ms_per_step"] and len(r["val_oa_curve"]) == 2
    assert abs(r["selected_threshold"] - r["sweep_best_threshold"]) < 1e-6
    assert set(r["results"]) == set(repro_drill.METHODS)
    for method, rows in r["results"].items():
        assert list(rows) == list(repro_drill.CORPORA), method
        for corpus, row in rows.items():
            assert np.isfinite(row["raw_oa"]) and np.isfinite(row["viterbi_oa"]), (method, corpus)
    shaun = r["results"]["shaun"]
    for corpus in ("validation", "test", "adc04"):
        assert shaun[corpus]["cross_check_max_abs"] < 1e-6, corpus
    assert list(r["chance_oa"]) == list(repro_drill.CORPORA)
    assert [r["chance_oa"][c] for c in repro_drill.CORPORA] == [round(v, 4) for v in seen]
    md = out.with_suffix(".md").read_text()
    assert "| corpus | chance | raw OA |" in md
    assert json.loads(out.with_suffix(".json").read_text())["regimes"] == results["regimes"]


@pytest.mark.parametrize("name", ["REPRO_r05", "REPRO_r04", "REPRO_r06_anything"])
def test_out_of_jax_artifacts_refused(tmp_path, name):
    out = tmp_path / name
    with pytest.raises(SystemExit):
        repro_drill.main(["--device", "cpu", "--families", "imm",
                          "--workdir", str(tmp_path / "work"), "--out", str(out)])
    assert not (tmp_path / "work").exists()
    assert not list(tmp_path.glob(f"{name}*"))


def test_no_card_without_device_cpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_drill.main(["--families", "msnet", "--workdir", str(tmp_path / "work"),
                          "--out", str(tmp_path / "REPRO_x")])
    assert not (tmp_path / "work").exists()


# ---- the --small convergence runs (tests/test_repro_drill.py's) ----------


@pytest.mark.slow
def test_repro_drill_small(tmp_path):
    out_base = tmp_path / "REPRO_test"
    results = repro_drill.main([
        "--small", "--families", "msnet", "--device", "cpu",
        "--workdir", str(tmp_path / "work"), "--out", str(out_base),
    ])
    r = results["regimes"]["clean"]["families"]["msnet"]
    assert r["best_val_oa"] > 0.5, r["best_val_oa"]
    assert r["epochs_run"] >= 3
    assert r["val_oa_curve"][-1] > r["val_oa_curve"][0] or max(r["val_oa_curve"]) > 0.5
    assert abs(r["selected_threshold"] - r["sweep_best_threshold"]) < 1e-6
    for corpus, row in r["results"]["shaun"].items():
        floor = r["chance_oa"][corpus]
        assert row["raw_oa"] > floor + 0.25, (corpus, row, floor)
        assert row["viterbi_oa"] > floor + 0.25, (corpus, row, floor)
        if corpus in ("validation", "test", "adc04"):
            assert row["cross_check_max_abs"] < 1e-6, (corpus, row)
    md = out_base.with_suffix(".md").read_text()
    assert "| corpus | chance | raw OA |" in md
    data = json.loads(out_base.with_suffix(".json").read_text())
    assert "msnet" in data["regimes"]["clean"]["families"]


@pytest.mark.slow
def test_repro_drill_small_hard_regime(tmp_path):
    out_base = tmp_path / "REPRO_test_hard"
    results = repro_drill.main([
        "--small", "--regime", "hard", "--families", "msnet", "--device", "cpu",
        "--workdir", str(tmp_path / "work"), "--out", str(out_base),
    ])
    r = results["regimes"]["hard"]["families"]["msnet"]
    floor = r["chance_oa"]["validation"]
    assert r["best_val_oa"] > floor + 0.10, (r["best_val_oa"], floor)
    assert r["epochs_run"] >= 3
    data = json.loads(out_base.with_suffix(".json").read_text())
    assert "msnet" in data["regimes"]["hard"]["families"]
    md = out_base.with_suffix(".md").read_text()
    assert "Regime: hard" in md
