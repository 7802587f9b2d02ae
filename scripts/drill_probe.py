"""Measurements behind the reproduction drill's rows (cli/repro_drill.py)
against the JAX package's REPRO_r05.

CPU, needs jax:
- imm: imm's drill row (`eval --debug --external-eval --original
  --calibrate-threshold`) on one fake corpus at the drill's size, three
  ways: the JAX package's app, the port with its own NMF draws (a CPU
  torch.Generator), and the port started from the JAX package's draws
  (tests/test_torch_imm.py::patch_fits_to_jax_draws). The corpus is byte
  for byte the JAX writer's, so what separates the first two rows is the
  draws alone where the third equals the first.
- decode: a trained drill checkpoint's logits (--ckpt, msnet) on the
  validation, test and adc04 tracks, decoded and scored by the port's
  DecoderSetup and by the JAX package's, each built from the same
  validation labels, under the three observation models.
- witness: one family (--family) trained by the JAX package's app and by
  the port's (`train --debug`, --epochs epochs of --steps steps) on one
  corpus of --regime at the drill's size, the port started from the JAX
  package's seed-0 initial weights, r05's (models/convert.py). Each epoch:
  both validation OAs, the learning rate in use, the weights' norm, the
  running averages' means, and the port's weights and running averages
  against the JAX package's. What separates a fault of the port from its
  own initial weights. Writes those weights for `jaxinit`.

GPU:
- steps: msnet trained for --steps steps from the same initial weights and
  the same batches (features on the CPU) on the card and on the CPU: each
  step's loss, the first step's gradients and BatchNorm averages, the
  validation OA of both and of the card's weights on the CPU.
- epochs: msnet trained through the app (`train --debug`, features on the
  card) for --epochs epochs of --steps steps; after each epoch the
  validation OA by the BatchNorm running averages (the app's), by each
  snippet's own batch statistics, and the training tracks' OA by the
  running averages.
- jaxinit: the drill for --family in --regime at its full budget, the port
  started from the weights `witness` wrote (--workdir), its artifact at
  --out.
- seeds: one family (--family) trained through the app at the drill's
  full budget in --regime from each initial-weight seed of --seeds (the
  app draws seed 0), and with the apps' `--bf16` (--bf16-seeds): each
  run's best validation OA, best epoch and curve.

    python3 scripts/drill_probe.py --parts witness --family msnet \
        --regime clean --epochs 8 --workdir runs/probe                   # CPU, jax
    python3 scripts/drill_probe.py --parts jaxinit --family msnet \
        --regime clean --workdir runs/probe                              # GPU
    python3 scripts/drill_probe.py --parts imm --workdir runs/probe      # CPU, jax
    python3 scripts/drill_probe.py --parts decode --ckpt ckpt_msnet.pt \
        --corpus <the drill's corpus dir>                                 # CPU, jax

Each part prints JSON lines; the GPU parts print the card's name and power
limit first. The corpora are made under --workdir (24 s tracks and 8 s
external ones, the drill's defaults; 8 s and 4 s, the drill's --small, for
steps).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from viterbi_spl_tpu_torch.apps import common as AC  # noqa: E402
from viterbi_spl_tpu_torch.apps import msnet  # noqa: E402
from viterbi_spl_tpu_torch.data import generate_fake_corpus  # noqa: E402
from viterbi_spl_tpu_torch.harness.train import TrainState  # noqa: E402

IMM_ARGV = ["eval", "--debug", "--external-eval", "--original", "--calibrate-threshold"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def corpus(root: Path, duration: float, ext: float, device: str) -> None:
    """A learnable clean fake corpus under root (reused when present), its
    roots in the environment."""
    if not (root / "env.json").exists():
        env = generate_fake_corpus(root, duration=duration, ext_duration=ext,
                                   rwc_duration=ext, rich=True, device=device)
        (root / "env.json").write_text(json.dumps(env))
    os.environ.update(json.loads((root / "env.json").read_text()))


def imm_row(res) -> dict:
    row = {"mdb_test": [res["original"]["mean_oa"], res["raw_mean_oa"], res["viterbi_mean_oa"]],
           "calibrated_threshold": res["calibration"]["best_threshold"]}
    for c in ("adc04", "mirex05", "mir1k"):
        row[c] = [res[c]["original"]["mean_oa"], res[c]["raw_mean_oa"], res[c]["viterbi_mean_oa"]]
    return row


def part_imm(workdir: Path) -> None:
    import jax
    import pytest

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_imm import patch_fits_to_jax_draws
    from viterbi_spl_tpu.apps import imm as jax_imm
    from viterbi_spl_tpu_torch.apps import imm as port_imm

    corpus(workdir / "corpus24", 24.0, 8.0, "cpu")
    emit({"probe": "imm", "run": "jax", "columns": "original, thresholding, viterbi OA",
          **imm_row(jax_imm.main(IMM_ARGV))})
    emit({"probe": "imm", "run": "port, its own draws",
          **imm_row(port_imm.main(IMM_ARGV + ["--device", "cpu"]))})
    with pytest.MonkeyPatch.context() as mp:
        patch_fits_to_jax_draws(mp)
        emit({"probe": "imm", "run": "port, the JAX package's draws",
              **imm_row(port_imm.main(IMM_ARGV + ["--device", "cpu"]))})


def part_decode(ckpt: Path, corpus_dir: Path) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from viterbi_spl_tpu.apps import common as JC
    from viterbi_spl_tpu.apps import msnet as jax_msnet
    from viterbi_spl_tpu.harness.evaluate import evaluate_posteriorgrams as jax_evaluate
    from viterbi_spl_tpu_torch.harness.evaluate import evaluate_posteriorgrams
    from viterbi_spl_tpu_torch.harness.train import Trainer

    os.environ.update(json.loads((corpus_dir / "env.json").read_text()))
    cfg, jcfg = msnet.config(), jax_msnet.config()
    datasets = msnet.build_real_datasets(debug=True, device="cpu")
    datasets.update(msnet.build_external_datasets(debug=True, device="cpu"))
    model, params, stats = AC.init_model(cfg, seed=0, device="cpu")
    state = Trainer(None, None, ckpt, family="msnet").restore(
        TrainState(params=params, batch_stats=stats))
    for method in ("shaun", "softmax-unscaled", "softmax-scaled"):
        setup = AC.build_decoder_setup(cfg, datasets["validation"], state.voicing_threshold,
                                       method, "cpu")
        jsetup = JC.build_decoder_setup(jcfg, datasets["validation"], state.voicing_threshold,
                                        method)
        for name in ("validation", "test", "adc04"):
            tracks = AC.tracks_for_evaluation(cfg, model, datasets[name])
            port, ref = evaluate_posteriorgrams(setup, tracks), jax_evaluate(jsetup, tracks)
            emit({"probe": "decode", "method": method, "set": name,
                  "threshold": state.voicing_threshold,
                  "port": [port["raw_mean_oa"], port["viterbi_mean_oa"]],
                  "jax": [float(ref["raw_mean_oa"]), float(ref["viterbi_mean_oa"])]})


def _train(dev, batches, datasets):
    model, params, stats = AC.init_model(msnet.config(), seed=0, device=dev)
    cfg = msnet.config()
    opt = AC.make_optimizer(cfg, model, 12)
    step = AC.make_train_step(cfg, model)
    st = TrainState(params=params, batch_stats=stats, opt_state=opt)
    losses, first = [], None
    for k, b in enumerate(batches):
        st.params, st.batch_stats, st.opt_state, loss, _ = step(
            st.params, st.batch_stats, st.opt_state, b, k, 0.5)
        losses.append(float(loss))
        if k == 0:
            first = ({n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                     {n: t.detach().cpu().double().clone() for n, t in st.batch_stats.items()})
    val = AC.make_validate(cfg, model, datasets["validation"])(st)["oa"]
    state = ({n: p.detach().cpu().clone() for n, p in st.params.items()},
             {n: t.detach().cpu().clone() for n, t in st.batch_stats.items()})
    return losses, first, val, state


def part_steps(workdir: Path, steps: int) -> None:
    corpus(workdir / "corpus8", 8.0, 4.0, "cpu")
    cfg = msnet.config()
    datasets = msnet.build_real_datasets(debug=True, device="cpu")
    gen = AC.training_batches(cfg, datasets["training"], np.random.default_rng(0), "cpu")
    batches = [next(gen) for _ in range(steps)]
    cpu, card = (_train(d, batches, datasets) for d in ("cpu", "cuda"))
    grad_err = {n: float((g - card[1][0][n]).abs().max() / g.abs().max().clamp_min(1e-30))
                for n, g in cpu[1][0].items()}
    bn_err = {n: float((t - card[1][1][n]).abs().max()) for n, t in cpu[1][1].items()}
    model, params, stats = AC.init_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for n, t in params.items():
            t.copy_(card[3][0][n])
        for n, t in stats.items():
            t.copy_(card[3][1][n])
    on_cpu = AC.make_validate(cfg, model, datasets["validation"])(
        TrainState(params=params, batch_stats=stats))["oa"]
    emit({"probe": "steps", "steps": steps, "loss_cpu": cpu[0], "loss_card": card[0],
          "loss_rel_diff": [abs(a - b) / abs(a) for a, b in zip(cpu[0], card[0])],
          "first_step_grad_err": grad_err, "first_step_bn_err": bn_err,
          "val_oa_cpu": cpu[2], "val_oa_card": card[2], "card_weights_val_oa_on_cpu": on_cpu})


def part_epochs(workdir: Path, epochs: int, steps: int) -> None:
    corpus(workdir / "corpus24", 24.0, 8.0, "cuda")
    validate_of, forward = AC.make_validate, AC._forward
    rows = []

    def make_validate(cfg, model, dataset):
        app_validate = validate_of(cfg, model, dataset)
        on_training = validate_of(cfg, model,
                                  msnet.build_real_datasets(debug=True, device="cuda")["training"])

        def validate(state):
            out = app_validate(state)
            AC._forward = lambda c, m, batch_stats: forward(c, m, True)
            try:
                by_batch = app_validate(state)["oa"]
            finally:
                AC._forward = forward
            rows.append({"val_running_averages": out["oa"], "val_batch_statistics": by_batch,
                         "training_running_averages": on_training(state)["oa"]})
            emit({"probe": "epochs", "epoch": len(rows) - 1, **rows[-1]})
            return out

        return validate

    AC.make_validate = make_validate
    try:
        msnet.main(["train", "--debug", "--ckpt", str(workdir / "epochs.pt"), "--epochs",
                    str(epochs), "--steps-per-epoch", str(steps), "--patience", str(epochs)])
    finally:
        AC.make_validate = validate_of


def part_seeds(workdir: Path, family: str, regime: str, seeds, bf16_seeds, jax_seeds) -> None:
    from viterbi_spl_tpu_torch.cli.repro_drill import FAMILY_BUDGET, _events, _scalar_curve

    app = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}")
    root = workdir / f"corpus24_{regime}"
    if not (root / "env.json").exists():
        env = generate_fake_corpus(root, duration=24.0, ext_duration=8.0, rwc_duration=8.0,
                                   rich=True, hard=regime == "hard", device="cuda")
        (root / "env.json").write_text(json.dumps(env))
    os.environ.update(json.loads((root / "env.json").read_text()))
    budget = {**dict(epochs=60, patience=6, steps_per_epoch=24), **FAMILY_BUDGET.get(family, {})}
    init_model = AC.init_model

    runs = ([(seed, "float32") for seed in seeds] + [(seed, "--bf16") for seed in bf16_seeds]
            + [(seed, "jax weights") for seed in jax_seeds])
    for seed, variant in runs:
        def seeded(cfg, kw=None, seed_=seed, device=None, jax_weights=variant == "jax weights",
                   **_):
            model, params, stats = init_model(cfg, kw, seed=seed_, device=device)
            if jax_weights:
                model.load_state_dict(torch.load(workdir / f"jax_init_{family}_{seed_}.pt",
                                                 weights_only=True), strict=True)
            return model, params, stats

        AC.init_model = seeded
        log = workdir / f"seeds_{family}_{regime}_{seed}_{variant.strip('-').replace(' ', '')}"
        shutil.rmtree(log, ignore_errors=True)  # its event log appends
        try:
            state = app.main(["train", "--debug", "--ckpt", str(log / "ck.pt"),
                              "--epochs", str(budget["epochs"]),
                              "--steps-per-epoch", str(budget["steps_per_epoch"]),
                              "--patience", str(budget["patience"]), "--log-dir", str(log),
                              *(["--bf16"] if variant == "--bf16" else [])])
        finally:
            AC.init_model = init_model
        events = _events(log)
        emit({"probe": "seeds", "family": family, "regime": regime, "seed": seed,
              "variant": variant,
              "best_val_oa": state.best_oa, "best_epoch": state.best_epoch,
              "val_oa_curve": [round(v, 4) for v in _scalar_curve(events, "val_oa")],
              "ms_per_step": 1e3 * sum(_scalar_curve(events, "train_step_seconds"))
              / max(sum(_scalar_curve(events, "train_steps")), 1)})


def _figures(sd: dict, ref: dict | None = None) -> dict:
    """A state dict's (the port's names) weights' L2 norm and BatchNorm
    running averages' mean; against `ref` (the same names), the largest
    difference of any weight and any running average over that tensor's
    largest |value| in ref."""
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    weights = [k for k in sd if k not in stats]
    out = {"weight_norm": float(sum(float(sd[k].double().pow(2).sum()) for k in weights) ** 0.5),
           "running_mean_mean": float(np.mean([float(sd[k].double().mean())
                                               for k in stats if k.endswith(".mean")] or [0])),
           "running_var_mean": float(np.mean([float(sd[k].double().mean())
                                              for k in stats if k.endswith(".var")] or [0]))}
    if ref is not None:
        def rel(keys):
            return max(float((sd[k].double() - ref[k].double()).abs().max()
                             / ref[k].double().abs().max().clamp_min(1e-30)) for k in keys)
        out["weights_rel_diff"] = rel(weights)
        out["running_averages_rel_diff"] = rel(stats) if stats else 0.0
    return out


def _to_jax(family: str, sd: dict, params, stats):
    """A port state dict -> the JAX package's (params, batch_stats) trees,
    shaped as the given ones: models/convert.py's map inverted, leaf by leaf
    (each leaf's elements numbered through `convert` show where it lands)."""
    import jax

    from viterbi_spl_tpu_torch.models.convert import convert

    leaves, treedef = jax.tree_util.tree_flatten((params, stats))
    out = []
    for i, leaf in enumerate(leaves):
        numbered = [np.zeros(np.shape(x), np.float32) for x in leaves]
        numbered[i] = np.arange(1, leaf.size + 1, dtype=np.float32).reshape(leaf.shape)
        flat = np.zeros(leaf.size, np.float32)
        for k, t in convert(family, *jax.tree_util.tree_unflatten(treedef, numbered))[0].items():
            at = t.numpy().ravel()
            hit = at > 0
            flat[at[hit].astype(np.int64) - 1] = sd[k].detach().cpu().numpy().ravel()[hit]
        out.append(flat.reshape(np.shape(leaf)))
    return jax.tree_util.tree_unflatten(treedef, out)


def part_jaxweights(workdir: Path, family: str, seeds) -> None:
    """The JAX package's initial weights of `family` for each seed of
    `seeds` (its app draws PRNGKey(0)), converted, to
    workdir/jax_init_<family>_<seed>.pt (`seeds --jax-seeds` trains from them)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from viterbi_spl_tpu_torch.models.convert import convert

    cfg = importlib.import_module(f"viterbi_spl_tpu.apps.{family}").config()
    sample = jnp.zeros((1, cfg.snippet_len, *cfg.feature_shape), jnp.float32)
    if cfg.input_adapter is not None:
        sample = cfg.input_adapter(sample)
    model = cfg.make_model(dtype=cfg.compute_dtype)
    for seed in seeds:
        v = model.init(jax.random.PRNGKey(seed), sample, train=False)
        sd = convert(family, *(jax.tree_util.tree_map(np.asarray, v.get(k, {}))
                               for k in ("params", "batch_stats")))[0]
        torch.save(sd, workdir / f"jax_init_{family}_{seed}.pt")
        emit({"probe": "jaxweights", "family": family, "seed": seed,
              "weight_norm": _figures(sd)["weight_norm"]})


def part_portweights(workdir: Path, family: str, seeds) -> None:
    """The port's initial weights of `family` for each seed of `seeds` (they
    depend on the torch version) to workdir/port_init_<family>_<seed>.pt,
    with the torch version printed (`witness --start <file>` trains the
    JAX package's app and the port's from them)."""
    cfg = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}").config()
    for seed in seeds:
        sd = AC.init_model(cfg, seed=seed)[0].state_dict()
        torch.save(sd, workdir / f"port_init_{family}_{seed}.pt")
        emit({"probe": "portweights", "family": family, "seed": seed, "torch": torch.__version__,
              "weight_norm": _figures(sd)["weight_norm"]})


def part_witness(workdir: Path, family: str, regime: str, epochs: int, steps: int,
                 start_from: str) -> None:
    """The JAX package's app and the port's, each `train --debug` for
    `epochs` epochs of `steps` steps (patience `epochs`) on one fake corpus
    at the drill's size, on the CPU, both from the same initial weights:
    the JAX package's seed-0 ones (start_from "jax", models/convert.py),
    the port's seed-0 ones ("port") or a port state dict's (a path; the
    JAX package's through convert's map inverted). After each
    epoch: both validation OAs, the learning rate in use, the weights' norm
    and the running averages' means, and the port's weights and running
    averages against the JAX package's. With "jax" it writes those weights
    to workdir/jax_init_<family>_0.pt (part `jaxinit` trains from them on
    the card)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from viterbi_spl_tpu.apps import common as JC
    from viterbi_spl_tpu_torch.models.convert import convert

    root = workdir / f"corpus24_{regime}"
    if not (root / "env.json").exists():
        env = generate_fake_corpus(root, duration=24.0, ext_duration=8.0, rwc_duration=8.0,
                                   rich=True, hard=regime == "hard", device="cpu")
        (root / "env.json").write_text(json.dumps(env))
    os.environ.update(json.loads((root / "env.json").read_text()))
    jax_app = importlib.import_module(f"viterbi_spl_tpu.apps.{family}")
    port_app = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}")
    argv = ["train", "--debug", "--epochs", str(epochs), "--steps-per-epoch", str(steps),
            "--patience", str(epochs)]

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    tag = Path(start_from).stem
    jax_rows, start = [], {}
    j_init, j_validate = JC.init_model, JC.make_validate

    def jax_init(cfg, sample):
        model, params, stats = j_init(cfg, sample)
        if start_from == "jax":
            start.update(convert(family, host(params), host(stats))[0])
            return model, params, stats
        start.update(AC.init_model(port_app.config(), seed=0)[0].state_dict()
                     if start_from == "port" else torch.load(start_from, weights_only=True))
        params, stats = jax.tree_util.tree_map(jnp.asarray,
                                               _to_jax(family, start, params, stats))
        return model, params, stats

    def jax_make_validate(cfg, model, dataset):
        validate = j_validate(cfg, model, dataset)

        def run(state):
            out = validate(state)
            count = int(jax.tree_util.tree_leaves(state.opt_state)[0])
            lr = (cfg.lr_schedule(cfg.learning_rate, steps)(count) if cfg.lr_schedule
                  else cfg.learning_rate)
            sd = convert(family, host(state.params), host(state.batch_stats))[0]
            jax_rows.append((out["oa"], float(lr), sd))
            return out

        return run

    JC.init_model, JC.make_validate = jax_init, jax_make_validate
    try:
        jax_app.main(argv + ["--ckpt", str(workdir / f"witness_{family}_{tag}_jax")])
    finally:
        JC.init_model, JC.make_validate = j_init, j_validate
    if start_from == "jax":
        torch.save(start, workdir / f"jax_init_{family}_0.pt")

    p_init, p_validate = AC.init_model, AC.make_validate

    def port_init(cfg, model_kwargs=None, seed=0, device=None):
        model, params, stats = p_init(cfg, model_kwargs, seed=seed, device=device)
        model.load_state_dict(start, strict=True)
        return model, params, stats

    def port_make_validate(cfg, model, dataset):
        validate = p_validate(cfg, model, dataset)

        def run(state):
            out = validate(state)
            k = len(port_rows)
            sd = {n: t.detach().cpu() for n, t in {**state.params, **state.batch_stats}.items()}
            port_rows.append(out["oa"])
            emit({"probe": "witness", "family": family, "regime": regime,
                  "start": start_from, "epoch": k,
                  "val_oa_jax": jax_rows[k][0], "val_oa_port": out["oa"],
                  "lr_jax": jax_rows[k][1], "lr_port": state.opt_state.param_groups[0]["lr"],
                  "jax": _figures(jax_rows[k][2]), "port": _figures(sd, jax_rows[k][2])})
            return out

        return run

    port_rows = []
    AC.init_model, AC.make_validate = port_init, port_make_validate
    try:
        port_app.main(argv + ["--ckpt", str(workdir / f"witness_{family}_{tag}_port.pt"),
                              "--device", "cpu"])
    finally:
        AC.init_model, AC.make_validate = p_init, p_validate


def part_jaxinit(workdir: Path, family: str, regime: str, out: str) -> None:
    """The drill (cli/repro_drill.py) for one family and regime at its full
    budget on the card, the port started from workdir/jax_init_<family>.pt
    (part `witness` writes it): the JAX package's seed-0 initial weights,
    r05's."""
    from viterbi_spl_tpu_torch.cli import repro_drill

    start = torch.load(workdir / f"jax_init_{family}_0.pt", weights_only=True)
    init_model = AC.init_model

    def jax_init(cfg, model_kwargs=None, seed=0, device=None):
        model, params, stats = init_model(cfg, model_kwargs, seed=seed, device=device)
        model.load_state_dict(start, strict=True)
        return model, params, stats

    AC.init_model = jax_init
    try:
        repro_drill.main(["--families", family, "--regime", regime,
                          "--workdir", str(workdir / "repro_jax_init"), "--out", out])
    finally:
        AC.init_model = init_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="witness")
    ap.add_argument("--workdir", type=Path, default=Path("runs/drill_probe"))
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--ckpt", type=Path, help="decode: a drill's msnet checkpoint")
    ap.add_argument("--family", default="ftanet",
                    help="the family (seeds, witness, jaxinit, jaxweights, portweights)")
    ap.add_argument("--regime", default="hard", choices=("clean", "hard"))
    ap.add_argument("--seeds", default="1,2", help="seeds, portweights: the port's seeds")
    ap.add_argument("--bf16-seeds", default="", help="seeds: seeds to train with --bf16")
    ap.add_argument("--jax-seeds", default="",
                    help="seeds, jaxweights: seeds of the JAX package's initial weights")
    ap.add_argument("--start", default="jax",
                    help="witness: both start from the JAX package's seed-0 weights (jax), "
                         "the port's (port) or a port state dict's (its path)")
    ap.add_argument("--corpus", type=Path, help="decode: the drill's corpus directory")
    ap.add_argument("--out", default="runs/REPRO_h100_jax_init",
                    help="jaxinit: the drill's artifact")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    args.workdir.mkdir(parents=True, exist_ok=True)
    if parts & {"steps", "epochs", "seeds", "jaxinit"}:
        if not torch.cuda.is_available():
            print("drill_probe: steps, epochs, seeds and jaxinit need CUDA", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip(), flush=True)
    if "imm" in parts:
        part_imm(args.workdir)
    if "decode" in parts:
        part_decode(args.ckpt, args.corpus)
    if "steps" in parts:
        part_steps(args.workdir, args.steps)
    if "epochs" in parts:
        part_epochs(args.workdir, args.epochs, args.steps)
    if "portweights" in parts:
        part_portweights(args.workdir, args.family, [int(v) for v in args.seeds.split(",") if v])
    if "jaxweights" in parts:
        part_jaxweights(args.workdir, args.family, [int(v) for v in args.jax_seeds.split(",") if v])
    if "witness" in parts:
        part_witness(args.workdir, args.family, args.regime, args.epochs, args.steps, args.start)
    if "jaxinit" in parts:
        part_jaxinit(args.workdir, args.family, args.regime, args.out)
    if "seeds" in parts:
        def ints(text):
            return [int(v) for v in text.split(",") if v]
        part_seeds(args.workdir, args.family, args.regime, ints(args.seeds), ints(args.bf16_seeds),
                   ints(args.jax_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
