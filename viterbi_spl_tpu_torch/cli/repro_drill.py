"""Convergence-grade reproduction drill on the port (counterpart of
scripts/repro_drill.py).

Closes the reference's scientific loop — train -> calibrate -> decode ->
table (the docstring accuracy tables, dcnet/softmax_viterbi.py:55-84, and
the training_fn/inference_fn loop :3558-3597) — on the learnable fake
corpus, through the port's own app paths:

1. generates the learnable fake corpus (data/fake_corpus.py rich=True, and
   hard=True in the hard regime: chord-tone accompaniment, tremolo and
   broadband noise), with its CFPs on the run's device,
2. trains each family through the product app path (apps/<family>.py
   train) to early-stop convergence with real patience,
3. checks the checkpointed auto-selected voicing threshold against the
   sweep-threshold mode, and runs `infer --external-eval` under all three
   observation models (shaun / softmax-scaled / softmax-unscaled) over the
   six eval sets; imm runs `eval --external-eval --original
   --calibrate-threshold`; `--obs-surface FAMILY` adds the sweep-obs
   (p, scale) surface of an already trained checkpoint,
4. writes a BASELINE.md-format artifact (REPRO_h100.md + REPRO_h100.json at
   the repo root by default), merged across calls: across families, across
   regimes and with the obs surface, written after every family.

Every decode goes through the CUDA kernels on the card (K1/K2 for the five
NN families' banded matrices and imm's viterbi method, K3/K4 for imm's
original method); `--device cpu` runs their plain PyTorch versions. With no
card and no `--device cpu` it raises: there is no fall back to the CPU.

    python -m viterbi_spl_tpu_torch.cli.repro_drill --families msnet,jdc \
        [--regime clean|hard] [--workdir DIR] [--out BASE] [--device cpu]
    python -m viterbi_spl_tpu_torch.cli.repro_drill --device cpu \
        --families msnet --small            # the test-scale run
    python -m viterbi_spl_tpu_torch.cli.repro_drill --obs-surface msnet \
        --regime hard                       # after msnet trained there

What differs from the JAX script: `--device` instead of `--tpu`; the
checkpoint is the port's torch.save file (`ckpt_<family>.pt`), so the
default workdir is its own ($TMPDIR/vspl_repro_torch); each row's
`platform` is the card's name (or "cpu") and it also holds `steps_taken`
and `ms_per_step` (the Trainer's counts: the steps it ran and their
seconds, the event log's `train_steps` and `train_step_seconds`),
`train_wall_ms_per_step` (the train call's wall time over those steps:
the front-end, validation and checkpoint saves included) and
`kernel_launches` (the CUDA kernels each app call launched); the
artifact's config holds the card's name and power limit (nvidia-smi); a
family's event log is started afresh with its training; and an `--out`
whose name starts with REPRO_r0 (the JAX package's TPU artifacts) is
refused.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import resolve_device

REPO = Path(__file__).resolve().parents[2]

METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")
CORPORA = ("validation", "test", "adc04", "mirex05", "mir1k", "rwc")

# the JAX package's artifacts, which this drill never writes
PROTECTED_PREFIX = "REPRO_r0"


def _events(log_dir: Path) -> list[dict]:
    path = log_dir / "events.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def _scalar_curve(events, tag):
    return [e["value"] for e in events
            if e.get("kind") == "scalar" and e.get("tag") == tag]


def chance_oa(notes_list) -> float:
    """OA of the always-unvoiced predictor (= mean unvoiced fraction) —
    the floor any trained system must clear."""
    fr = [float(np.mean(np.asarray(n) <= 0.1)) for n in notes_list]
    return float(np.mean(fr))


# per-family budget overrides for the full (non --small) run, the JAX
# script's: jdc's and ftanet's eval-mode output is degenerate until their
# BatchNorm running statistics settle (~150-300 steps), so they get
# patience to survive the flat phase; dcnet (the deepest model on the
# 256-d NSGT features) learns slowest
FAMILY_BUDGET = {
    "jdc": dict(steps_per_epoch=24, epochs=30, patience=8),
    "ftanet": dict(steps_per_epoch=24, epochs=30, patience=12),
    "dcnet": dict(steps_per_epoch=48, epochs=40, patience=12),
}


def _platform(device: str) -> str:
    return torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"


def card_summary(device: str) -> dict:
    """The card's name and power limit as nvidia-smi reports them (the
    first GPU's line), or "cpu"."""
    if torch.device(device).type != "cuda":
        return dict(device="cpu")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(",")
    return dict(device=_platform(device), nvidia_smi=line,
                gpu_name=name.strip(), power_limit=limit.strip())


def _counted(launches: dict, what: str, fn, *args):
    """fn(*args), its kernel launches under launches[what]."""
    from ..hmm.viterbi_dense import counted_launches

    out, launches[what] = counted_launches(fn, *args)
    return out


def run_family(name: str, workdir: Path, env: dict, args) -> dict:
    app = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{name}")
    os.environ.update(env)
    ckpt = str(workdir / f"ckpt_{name}.pt")
    log_dir = workdir / f"log_{name}"
    # the event log appends: a rerun in the same workdir starts it afresh
    shutil.rmtree(log_dir, ignore_errors=True)
    dev = ["--device", args.device]

    budget = dict(epochs=args.epochs, patience=args.patience,
                  steps_per_epoch=args.steps_per_epoch)
    if not args.small:
        budget.update(FAMILY_BUDGET.get(name, {}))

    launches = {}
    t0 = time.time()
    state = _counted(launches, "train", app.main,
                     ["train", "--debug", "--ckpt", ckpt,
                      "--epochs", str(budget["epochs"]),
                      "--steps-per-epoch", str(budget["steps_per_epoch"]),
                      "--patience", str(budget["patience"]),
                      "--log-dir", str(log_dir), *dev])
    train_s = time.time() - t0
    events = _events(log_dir)
    val_curve = _scalar_curve(events, "val_oa")
    th_curve = _scalar_curve(events, "voicing_threshold")
    # the Trainer's counts: each epoch's steps and their seconds
    steps = int(sum(_scalar_curve(events, "train_steps")))
    step_s = sum(_scalar_curve(events, "train_step_seconds"))

    out = dict(
        family=name,
        platform=_platform(args.device),
        best_val_oa=float(state.best_oa),
        best_epoch=int(state.best_epoch),
        epochs_run=len(val_curve),
        selected_threshold=float(state.voicing_threshold),
        val_oa_curve=[round(v, 4) for v in val_curve],
        threshold_curve=[round(v, 4) for v in th_curve],
        train_seconds=round(train_s, 1),
        steps_taken=steps,
        ms_per_step=round(1e3 * step_s / max(steps, 1), 2),
        train_wall_ms_per_step=round(1e3 * train_s / max(steps, 1), 2),
    )

    # threshold sweep (the ftanet/threshold.py surface): the sweep's
    # argmax-VA threshold should agree with the checkpointed auto one
    sweep = _counted(launches, "sweep-threshold", app.main,
                     ["sweep-threshold", "--debug", "--ckpt", ckpt, *dev])
    out["sweep_best_threshold"] = float(sweep["best_threshold"])
    out["sweep_best_oa_threshold"] = float(sweep["best_oa_threshold"])

    # full evaluation surface: every corpus x every observation model
    per_method = {}
    for method in METHODS:
        res = _counted(launches, f"infer {method}", app.main,
                       ["infer", "--debug", "--ckpt", ckpt, "--external-eval",
                        "--viterbi-method", method, *dev])
        per_method[method] = {
            c: dict(
                raw_oa=float(res[c]["raw_mean_oa"]),
                viterbi_oa=float(res[c]["viterbi_mean_oa"]),
            )
            for c in CORPORA if c in res
        }
        if method == "shaun":
            # the production method gets the full metric set per corpus
            for c in CORPORA:
                if c not in res:
                    continue
                for path in ("raw", "viterbi"):
                    per_method[method][c][f"{path}_metrics"] = {
                        k: round(float(np.mean(v)), 4)
                        for k, v in res[c][path].items()
                        if k != "loss"
                    }
                per_method[method][c]["cross_check_max_abs"] = round(
                    max(abs(d) for d in res[c]["cross_check_diff_viterbi"]), 6
                )
    out["results"] = per_method
    out["kernel_launches"] = launches

    # chance floor per corpus (always-unvoiced OA) from the datasets the
    # app evaluated — rebuilt the same way
    ds = app.build_real_datasets(debug=True, device=args.device)
    ext = app.build_external_datasets(debug=True, device=args.device)
    floors = {}
    for c in CORPORA:
        d = ds.get(c) or ext.get(c)
        if d is not None:
            floors[c] = round(chance_oa([t.notes for t in d.tracks]), 4)
    out["chance_oa"] = floors
    return out


def run_imm(env: dict, args) -> dict:
    """The imm family needs no training (per-recording NMF fits at
    inference); its BASELINE rows are original / thresholding / viterbi
    OA over mdb + adc04/mirex05/mir1k (imm/main_imm.py:43,
    imm/thresholding.py:6-75), plus the log-energy threshold calibration
    (the 2.442347 provenance)."""
    os.environ.update(env)
    from ..apps import imm as imm_app

    launches = {}
    res = _counted(launches, "eval", imm_app.main,
                   ["eval", "--debug", "--external-eval", "--original",
                    "--calibrate-threshold", "--device", args.device])
    out = dict(
        family="imm",
        mdb_test=dict(
            thresholding_oa=float(res["raw_mean_oa"]),
            viterbi_oa=float(res["viterbi_mean_oa"]),
            original_oa=float(res["original"]["mean_oa"]),
        ),
        calibrated_threshold=float(res["calibration"]["best_threshold"]),
        kernel_launches=launches,
    )
    for c in ("adc04", "mirex05", "mir1k"):
        out[c] = dict(
            thresholding_oa=float(res[c]["raw_mean_oa"]),
            viterbi_oa=float(res[c]["viterbi_mean_oa"]),
            original_oa=float(res[c]["original"]["mean_oa"]),
        )
    return out


def run_obs_surface(args, env: dict, out_base: str) -> dict:
    """Attach the sweep-obs (p, scale) validation surface for one family to
    an existing artifact, reusing its trained checkpoint (no retraining)."""
    os.environ.update(env)
    fam = args.obs_surface
    app = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{fam}")
    ckpt = str(Path(args.workdir) / args.regime / f"ckpt_{fam}.pt")
    res = app.main(["sweep-obs", "--debug", "--ckpt", ckpt, "--device", args.device])
    surface = dict(
        ps=[float(p) for p in res["ps"]],
        scales=[float(s) for s in res["scales"]],
        viterbi_oa=[[round(float(v), 4) for v in row] for row in res["oa"]],
        best_p=float(res["best_p"]), best_scale=float(res["best_scale"]),
        reference_choice=dict(p=0.8, scale=2.0),
    )
    json_path = Path(out_base + ".json")
    results = json.loads(json_path.read_text())
    results["regimes"][args.regime]["families"][fam]["obs_surface"] = surface
    json_path.write_text(json.dumps(results, indent=1))
    Path(out_base + ".md").write_text(render_markdown(results, args))
    print(f"obs surface ({fam}, {args.regime}): best p={surface['best_p']}, "
          f"scale={surface['best_scale']}; wrote {out_base}.md / .json")
    return results


def _regime_markdown(reg: dict) -> list[str]:
    lines = []
    for fam, r in reg["families"].items():
        if fam == "imm":
            lines += [
                "## imm (no training: per-recording NMF fits)",
                "",
                f"- calibrated log-energy threshold "
                f"{r['calibrated_threshold']:.4f} (reference constant "
                f"2.442347 = logit(0.92), imm/thresholding.py:80)",
                "",
                "| corpus | original OA | thresholding OA | viterbi OA |",
                "|---|---|---|---|",
            ]
            for c in ("mdb_test", "adc04", "mirex05", "mir1k"):
                row = r[c]
                lines.append(
                    f"| {c} | {row['original_oa']:.4f} | "
                    f"{row['thresholding_oa']:.4f} | "
                    f"{row['viterbi_oa']:.4f} |"
                )
            lines.append("")
            continue
        lines += [
            f"## {fam}",
            "",
            f"- best val OA **{r['best_val_oa']:.4f}** @ epoch "
            f"{r['best_epoch']} ({r['epochs_run']} epochs run, "
            f"{r['train_seconds']:.0f}s)",
            f"- auto-selected voicing threshold "
            f"{r['selected_threshold']:.2f} (sweep argmax-VA "
            f"{r['sweep_best_threshold']:.2f}, argmax-OA "
            f"{r['sweep_best_oa_threshold']:.2f})",
            f"- val-OA curve: {r['val_oa_curve']}",
            f"- threshold curve: {r['threshold_curve']}",
            "",
            "| corpus | chance | raw OA | viterbi (shaun) | Δ | "
            "viterbi (softmax-unscaled) | viterbi (softmax-scaled) |",
            "|---|---|---|---|---|---|---|",
        ]
        shaun = r["results"]["shaun"]
        for c in CORPORA:
            if c not in shaun:
                continue
            delta = shaun[c]["viterbi_oa"] - shaun[c]["raw_oa"]
            row = [
                c,
                f"{r['chance_oa'].get(c, float('nan')):.3f}",
                f"{shaun[c]['raw_oa']:.4f}",
                f"{shaun[c]['viterbi_oa']:.4f}",
                f"{delta:+.4f}",
            ]
            for m in ("softmax-unscaled", "softmax-scaled"):
                row.append(f"{r['results'][m][c]['viterbi_oa']:.4f}")
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
        if "obs_surface" in r:
            s = r["obs_surface"]
            lines += [
                "### shaun observation (p, scale) validation surface "
                "(viterbi OA)",
                "",
                "| p \\ scale | " + " | ".join(f"{v:g}" for v in s["scales"])
                + " |",
                "|---|" + "---|" * len(s["scales"]),
            ]
            for i, p in enumerate(s["ps"]):
                lines.append(
                    f"| {p:g} | " + " | ".join(
                        f"{v:.4f}" for v in s["viterbi_oa"][i]) + " |")
            lines += [
                "",
                f"- argmax: p={s['best_p']:g}, scale={s['best_scale']:g}; "
                f"reference validation choice p=0.8, scale=2 "
                "(dcnet/softmax_viterbi.py:41-50)",
                "",
            ]
    return lines


def render_markdown(results: dict, args) -> str:
    cfg = results.get("config", {})
    card = cfg.get("nvidia_smi") or cfg.get("device", "an unrecorded device")
    lines = [
        "# REPRO — convergence-grade fake-corpus reproduction drill",
        "",
        f"Generated by `python -m viterbi_spl_tpu_torch.cli.repro_drill` on "
        f"{card} (epochs<={args.epochs}, "
        f"patience={args.patience}, steps/epoch={args.steps_per_epoch}, "
        f"mdb track duration {args.duration:.0f}s). The synthetic "
        "learnable corpus stands in for the unmounted real corpora; the "
        "chains are the PRODUCT app paths (train -> auto-threshold -> "
        "checkpoint -> infer --external-eval). Numbers are mean OA over "
        "the split (2 tracks/corpus at --debug scale). `chance` is the "
        "always-unvoiced OA floor.",
        "",
    ]
    for regime in ("clean", "hard"):
        if regime not in results["regimes"]:
            continue
        lines += [
            f"# Regime: {regime}",
            "",
            ("Near-noiseless renders — raw OA saturates; this table is "
             "the regression floor." if regime == "clean" else
             "Degraded mixtures (chord-tone accompaniment, tremolo, "
             "broadband noise; `data/fake_corpus.py` hard=True) targeting "
             "the reference's raw-OA ~0.7-0.85 band, where the paper's "
             "headline — Viterbi post-processing improves OA — is "
             "demonstrable. Δ = viterbi(shaun) − raw."),
            "",
        ]
        lines += _regime_markdown(results["regimes"][regime])
    lines += [
        "### Reading the softmax columns",
        "",
        "The softmax-scaled observation model divides the peak softmax by "
        "the state priors (likelihood = posterior/prior, "
        "dcnet/softmax_viterbi.py:2530-2579). When the validation split "
        "does not cover the pitch grid, unseen bins sit at the init-prob "
        "floor and 1/prior boosts harmonic side peaks by orders of "
        "magnitude — observed as a full OA collapse on an early "
        "narrow-center corpus (oracle-verified as the algorithm, not the "
        "kernels: `setup.decode` matched the NumPy oracle bit-for-bit). "
        "The committed corpus sweeps most of the singing range per "
        "track, so the priors are populated and the softmax columns are "
        "healthy; the production method is shaun either way.",
        "",
    ]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="reproduction drill")
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "vspl_repro_torch"),
                    help="corpus, checkpoints and event logs (default "
                         "$TMPDIR/vspl_repro_torch)")
    ap.add_argument("--families", default="msnet,jdc")
    ap.add_argument("--regime", choices=("clean", "hard"), default="clean")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--duration", type=float, default=24.0,
                    help="seconds per fake medleydb track")
    ap.add_argument("--ext-duration", type=float, default=8.0)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--patience", type=int, default=6)
    ap.add_argument("--steps-per-epoch", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="artifact basename (default REPRO_h100 at the repo "
                         "root); a name starting with REPRO_r0 is refused")
    ap.add_argument("--small", action="store_true",
                    help="test scale: short tracks, few epochs")
    ap.add_argument("--fresh-corpus", action="store_true")
    ap.add_argument("--obs-surface", metavar="FAMILY", default=None,
                    help="skip training: run the sweep-obs (p, scale) grid "
                    "(tonet/hyper_parameter_selection.py; reference choice "
                    "p=0.8 scale=2, dcnet/softmax_viterbi.py:41-50) on the "
                    "family's ALREADY-TRAINED checkpoint in the workdir and "
                    "merge the surface into the artifact")
    args = ap.parse_args(argv)
    out_base = args.out or str(REPO / "REPRO_h100")
    if Path(out_base).name.startswith(PROTECTED_PREFIX):
        ap.error(f"--out {out_base}: {PROTECTED_PREFIX}* are the JAX package's "
                 "TPU artifacts; pick another name")
    args.device = str(resolve_device(args.device))
    if args.small:
        args.duration = 8.0
        args.ext_duration = 4.0
        # the hard-v2 regime is calibrated at FULL budget (--small
        # underestimates difficulty); give it more epochs so the
        # learnability assertion clears the chance floor
        args.epochs = 14 if args.regime == "hard" else 8
        args.patience = 14 if args.regime == "hard" else 8
        args.steps_per_epoch = 12

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    hard = args.regime == "hard"
    corpus_root = workdir / ("corpus_hard" if hard else "corpus")
    manifest = corpus_root / "manifest.json"
    want = dict(duration=args.duration, ext_duration=args.ext_duration,
                rich=True, hard=hard, version=4)  # v4: hard-v2 gains
    if args.fresh_corpus or not manifest.exists() or \
            json.loads(manifest.read_text()) != want:
        from ..data import generate_fake_corpus

        if corpus_root.exists():
            shutil.rmtree(corpus_root)
        print("generating learnable corpus ...", flush=True)
        env = generate_fake_corpus(
            corpus_root, duration=args.duration,
            ext_duration=args.ext_duration, rwc_duration=args.ext_duration,
            rich=True, hard=hard, device=args.device,
        )
        (corpus_root / "env.json").write_text(json.dumps(env))
        manifest.write_text(json.dumps(want))
    env = json.loads((corpus_root / "env.json").read_text())

    if args.obs_surface:
        return run_obs_surface(args, env, out_base)

    results = dict(
        generated=time.strftime("%Y-%m-%d %H:%M:%S"),
        config=dict(duration=args.duration, epochs=args.epochs,
                    patience=args.patience,
                    steps_per_epoch=args.steps_per_epoch,
                    **card_summary(args.device)),
        regimes={args.regime: dict(families={})},
    )
    famdir = workdir / args.regime
    famdir.mkdir(exist_ok=True)
    json_path = Path(out_base + ".json")

    def _write(results):
        # merge with a previous invocation over the same artifact (e.g.
        # the trained families first, then a separate --families imm run,
        # or the clean regime first and the hard regime after). Written
        # after EVERY family so a crash in family N can't lose 1..N-1.
        if json_path.exists():
            prev = json.loads(json_path.read_text())
            merged = dict(prev)
            merged.update(
                {k: v for k, v in results.items() if k != "regimes"})
            regs = dict(prev.get("regimes", {}))
            for reg, rv in results["regimes"].items():
                cur = regs.get(reg, dict(families={}))
                cur["families"] = {**cur.get("families", {}),
                                   **rv["families"]}
                regs[reg] = cur
            merged["regimes"] = regs
            results = merged
        json_path.write_text(json.dumps(results, indent=1))
        Path(out_base + ".md").write_text(render_markdown(results, args))
        return results

    for fam in args.families.split(","):
        print(f"=== {fam} ({args.regime}) ===", flush=True)
        if fam == "imm":
            results["regimes"][args.regime]["families"]["imm"] = \
                run_imm(env, args)
        else:
            results["regimes"][args.regime]["families"][fam] = \
                run_family(fam, famdir, env, args)
        results = _write(results)
    print(f"wrote {out_base}.md / .json")
    return results


if __name__ == "__main__":
    main()
