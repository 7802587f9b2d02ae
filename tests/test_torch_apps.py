"""The port's training path (viterbi_spl_tpu_torch/apps/common.py and the
family apps) against the JAX package's, on the CPU: the same seeded
weights (the JAX model's param tree filled with seeded values, carried
across with models/convert.py), the same synthetic datasets and batch
stream (apps/common.py::synthetic_dataset and training_batches: the JAX
package's NumPy draws), dropout off on both sides (the JAX nn.Dropout
intercepted to the identity, the port's dropout generator None).

Sizes: every model at its app width (TONet at attn_dim 32); synthetic
tracks of 96 frames (the --debug ones have 400), so that dcnet's and
msnet's 1,200-frame snippets take the short-track fallback (`raw[:1]`) as
under --debug; the fixed-chunk families at chunks of 16 frames (ftanet,
TONet; jdc's 31) and batches of 16 (ftanet), 8 (jdc) and 4 (TONet).

Three train steps, each from the same state: before each step the port's
params and BatchNorm averages are set to the JAX package's (Adam's first
update is ~lr sign(g), so a gradient element near 0 that takes the other
sign moves a parameter by 2 lr and every later step apart). Per step:

- the batch equal; the loss within rtol 1e-5 (TONet 3e-5); the
  training-split counts equal;
- the BatchNorm running averages after the step within 1e-5: a running
  mean's difference over its channel's standard deviation (a mean that is
  ~0, as after a BatchNorm, is float noise on both sides), a running
  variance's over itself;
- gradients. msnet: within 1e-5 of each tensor's largest |g|. The others
  are held by the whole gradient's relative L2 error and by each tensor's
  largest error against the whole gradient's largest |g|
  (GRAD_TOL): their float32 gradients are ill-conditioned — the port's own
  float32 gradients differ from its float64 ones by 5.2e-3 (dcnet), 1.7e-2
  (jdc), 4.3e-3 (ftanet) and 8.7e-2 (TONet) of a tensor's largest, and by
  2.9e-5, 1.0e-3, 3.4e-4 and 9.0e-3 in relative L2, on these sizes
  (scripts/train_precision_probe.py), in BatchNorm's backward through
  batch statistics and the attention softmaxes — and the JAX package
  cannot be their float64 reference (flax's LSTM carry is float32;
  ftanet's and TONet's modules cast their softmaxes and logits to
  float32; XLA's float64 CPU convolutions are slow). The bounds are about
  three times what the test measures and prints (pytest -s);
- the first update, where |g| is above a tenth of its tensor's largest:
  within 1e-6 of the JAX package's.

ftanet and TONet: the JAX BatchNorm is run with flax's two-pass variance
(use_fast_variance=False, set by an interceptor), the port's documented
choice (models/layers.py): flax's default E[x^2] - E[x]^2 cancels on the
SF modules' chunk means (0.012 of the output in float32,
scripts/precision_probe.py), which no float32 comparison could see past.

Then, with the JAX package's weights after the three steps in both
models: validation (the 99-point threshold grid) gives the same OA and
threshold; inference (build_decoder_setup from the validation labels at
that threshold, the raw and Viterbi paths) within 1e-6 of the JAX
package's mean OAs on the validation and test splits; the calibration
modes (sweep-threshold, hard-vs-auto, sweep-obs) within 1e-6 on every
reported value.

The port's own app_main (train with events and tables as
tests/test_apps.py:274 checks them, infer, --dump-tracks, the calibration
modes, --resume, the refused flags) runs for msnet, and TONet's main with
another backbone and mode, whose checkpoint cli/transcribe.py's loader
reads.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from test_torch_models import flax_variables, no_dropout
from viterbi_spl_tpu.apps import common as JC
from viterbi_spl_tpu.apps import reports as JR
from viterbi_spl_tpu.data import training_snippets as j_training_snippets
from viterbi_spl_tpu.harness.train import TrainState as JTrainState
from viterbi_spl_tpu.models.tonet import TONet as JTONet
from viterbi_spl_tpu_torch.apps import common as TC
from viterbi_spl_tpu_torch.apps import reports as TR
from viterbi_spl_tpu_torch.harness.train import TrainState, restore_checkpoint, split_state_dict
from viterbi_spl_tpu_torch.models.convert import convert

# the families held here; ftanet's and TONet's runs, the longest, are held
# by tests/test_torch_apps_cfp.py with this file's checks (a file each, so
# that the test workers share them)
HERE = ("dcnet", "msnet", "jdc")
FRAMES = 96
CUT = dict(dcnet={}, msnet={}, ftanet=dict(snippet_len=16), jdc=dict(batch_size=8),
           tonet=dict(snippet_len=16))
TWO_PASS = ("ftanet", "tonet")
# TONet's: its float32 batch-statistics forward over 4 chunks (measured up
# to 9.3e-6 at the third step); the others' measured below 2e-6
LOSS_RTOL = dict(dcnet=1e-5, msnet=1e-5, ftanet=1e-5, jdc=1e-5, tonet=3e-5)
# (relative L2 of the whole gradient, the largest error of any tensor over
# the whole gradient's largest |g|), about 3x the largest measured over the
# three steps (dcnet 3.1e-5 and 7.4e-6, jdc 3.3e-3 and 1.1e-3, ftanet
# 8.8e-4 and 1.8e-3, TONet 9.3e-3 and 7.3e-3); msnet: None, held per tensor
# at 1e-5
GRAD_TOL = dict(dcnet=(1e-4, 3e-5), msnet=None, ftanet=(3e-3, 5e-3), jdc=(1e-2, 3e-3),
                tonet=(3e-2, 3e-2))
BN_TOL = 1e-5
OA_ATOL = 1e-6


def two_pass(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.BatchNorm):
        object.__setattr__(context.module, "use_fast_variance", False)
    return next_fun(*args, **kwargs)


def _grad_recorder(tx):
    """tx whose state also carries the last gradient it was given (the JAX
    train step's own gradient, unchanged)."""
    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, params=None):
        updates, inner = tx.update(g, state[0], params)
        return updates, (inner, g)

    return optax.GradientTransformation(init, update)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_dict(fam, params, bs):
    return convert(fam, _host(params), _host(bs))[0]


class _Run:
    """Both packages' training path for one family (module docstring)."""

    def __init__(self, fam):
        self.fam = fam
        jmod = importlib.import_module(f"viterbi_spl_tpu.apps.{fam}")
        tmod = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{fam}")
        self.jcfg = dataclasses.replace(jmod.config(), **CUT[fam])
        self.tcfg = dataclasses.replace(tmod.config(), **CUT[fam])
        if fam == "tonet":
            self.jcfg = dataclasses.replace(self.jcfg, make_model=lambda **kw: JTONet(attn_dim=32, **kw))
        ctx = [nn.intercept_methods(no_dropout)] + ([nn.intercept_methods(two_pass)]
                                                    if fam in TWO_PASS else [])
        self._ctx = ctx
        dropout_generator = TC.dropout_generator
        TC.dropout_generator = lambda *args, **kwargs: None  # the port's dropout off
        try:
            with self._jax():
                self._train()
                self._evaluate()
        finally:
            TC.dropout_generator = dropout_generator

    def _jax(self):
        import contextlib

        stack = contextlib.ExitStack()
        for c in self._ctx:
            stack.enter_context(c)
        return stack

    def _train(self):
        fam, jcfg, tcfg = self.fam, self.jcfg, self.tcfg
        self.jdata = {s: JC.synthetic_dataset(jcfg, n, FRAMES, seed) for s, n, seed in
                      (("training", 2, 0), ("validation", 1, 1), ("test", 1, 2))}
        self.tdata = {s: TC.synthetic_dataset(tcfg, n, FRAMES, seed) for s, n, seed in
                      (("training", 2, 0), ("validation", 1, 1), ("test", 1, 2))}
        self.jm = jcfg.make_model(dtype=jnp.float32)
        sample = self.jdata["training"][0].spectrogram[: jcfg.snippet_len][None]
        if jcfg.input_adapter is not None:
            sample = np.asarray(jcfg.input_adapter(jnp.asarray(sample)))
        v = flax_variables(self.jm, sample, seed=5)
        params, bs = v["params"], v["batch_stats"]
        tx = _grad_recorder(JC.make_optimizer(jcfg, 8))
        jstep = JC.make_train_step(jcfg, self.jm, tx)
        opt = tx.init(params)

        sd, kw = convert(fam, _host(params), _host(bs))
        self.model_kwargs = kw
        self.model = tcfg.make_model(dtype=torch.float32, **kw)
        self.model.load_state_dict(sd, strict=True)
        tp, tbs = split_state_dict(self.model)
        topt = TC.make_optimizer(tcfg, self.model, 8)
        tstep = TC.make_train_step(tcfg, self.model)

        jsnip = j_training_snippets(self.jdata["training"], jcfg.snippet_len, np.random.default_rng(0))
        tbatches = TC.training_batches(tcfg, self.tdata["training"], np.random.default_rng(0), "cpu")
        self.steps = []
        for step in range(3):
            raw = [next(jsnip) for _ in range(jcfg.batch_size)]
            items = [i for i in raw if len(i["notes"]) == jcfg.snippet_len] or raw[:1]
            jspec = np.stack([i["spectrogram"] for i in items])
            jnotes = np.stack([i["notes"] for i in items])
            tspec, tnotes = next(tbatches)
            with torch.no_grad():
                start = _torch_dict(fam, params, bs)
                for k, t in {**tp, **tbs}.items():
                    t.copy_(start[k])
            before = {k: t.detach().clone() for k, t in tp.items()}
            params, bs, opt, jl, jc = jstep(params, bs, opt, (jnp.asarray(jspec), jnp.asarray(jnotes)),
                                            step, 0.5)
            _, _, _, tl, tc = tstep(tp, tbs, topt, (tspec, tnotes), step, 0.5)
            after = _torch_dict(fam, params, bs)
            jgrads = _torch_dict(fam, opt[1], bs)
            self.steps.append(dict(
                batch_equal=np.array_equal(jspec, tspec.numpy()) and np.array_equal(jnotes, tnotes.numpy()),
                n_items=len(items), loss=(float(jl), float(tl)),
                counts={k: (np.asarray(jc[k]), tc[k].numpy()) for k in jc},
                grads={k: (jgrads[k], tp[k].grad.detach().clone()) for k in tp if tp[k].requires_grad},
                stats={k: (after[k], tbs[k].detach().clone()) for k in tbs},
                update={k: (after[k] - before[k], tp[k].detach() - before[k]) for k in tp},
            ))
        with torch.no_grad():
            final = _torch_dict(fam, params, bs)
            for k, t in {**tp, **tbs}.items():
                t.copy_(final[k])
        self.jstate = JTrainState(params=params, batch_stats=bs, opt_state=opt)
        self.tstate = TrainState(tp, tbs, opt_state=topt)

    def _evaluate(self):
        jcfg, tcfg = self.jcfg, self.tcfg
        self.val = (JC.make_validate(jcfg, self.jm, self.jdata["validation"])(self.jstate),
                    TC.make_validate(tcfg, self.model, self.tdata["validation"])(self.tstate))
        th = self.val[0]["voicing_threshold"]
        jsetup = JC.build_decoder_setup(jcfg, self.jdata["validation"], th)
        tsetup = TC.build_decoder_setup(tcfg, self.tdata["validation"], th, device="cpu")
        self.infer = {s: (JC.run_inference(jcfg, self.jm, self.jstate, self.jdata[s], jsetup),
                          TC.run_inference(tcfg, self.model, self.tdata[s], tsetup))
                      for s in ("validation", "test")}
        self.calib = {m: (JR.run_calibration_mode(m, jcfg, self.jm, self.jstate, self.jdata, jsetup,
                                                  hard_threshold=0.5),
                          TR.run_calibration_mode(m, tcfg, self.model, self.tdata, tsetup,
                                                  hard_threshold=0.5))
                      for m in ("sweep-threshold", "hard-vs-auto", "sweep-obs")}


_RUNS: dict = {}


def family_run(fam: str) -> _Run:
    """One _Run a family and process, shared by its tests."""
    if fam not in _RUNS:
        _RUNS[fam] = _Run(fam)
    return _RUNS[fam]


def _max_rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_train_steps(run):
    for i, st in enumerate(run.steps):
        what = f"{run.fam} step {i}"
        assert st["batch_equal"], what
        if run.fam in ("dcnet", "msnet"):
            assert st["n_items"] == 1, "the short-track fallback batch"
        assert st["loss"][1] == pytest.approx(st["loss"][0], rel=LOSS_RTOL[run.fam]), what
        for k, (a, b) in st["counts"].items():
            np.testing.assert_array_equal(b, a, err_msg=f"{what} count {k}")
        want = {k: w for k, (w, _) in st["stats"].items()}
        for k, (w, got) in st["stats"].items():
            # a running mean against its channel's standard deviation (a
            # mean that is ~0, as after a BatchNorm, is float noise on
            # both), a running variance against itself
            scale = want[k[: -len("mean")] + "var"].sqrt() if k.endswith(".mean") else w
            err = float(((got - w).abs() / scale).max())
            assert err <= BN_TOL, (what, k, err)
        grads = st["grads"]
        if GRAD_TOL[run.fam] is None:
            for k, (want, got) in grads.items():
                assert _max_rel(got, want) <= 1e-5, (what, k, _max_rel(got, want))
        else:
            l2_tol, max_tol = GRAD_TOL[run.fam]
            want = torch.cat([w.double().flatten() for w, _ in grads.values()])
            got = torch.cat([g.double().flatten() for _, g in grads.values()])
            gmax = float(want.abs().max())
            rel_l2 = float((got - want).norm() / want.norm())
            worst = max(float((g - w).abs().max()) for w, g in grads.values()) / gmax
            print(f"{what}: loss rel {abs(st['loss'][1] / st['loss'][0] - 1):.2e}, "
                  f"gradient rel L2 {rel_l2:.2e}, largest over the largest |g| {worst:.2e}")
            assert rel_l2 <= l2_tol and worst <= max_tol, what
        if i == 0:
            for k, (w, g) in grads.items():
                clear = w.abs() > 0.1 * w.abs().max()
                dj, dp = st["update"][k]
                assert float(((dp - dj).abs() * clear).max()) <= 1e-6, (what, k)


def check_validate(run):
    want, got = run.val
    assert got["voicing_threshold"] == want["voicing_threshold"]
    assert got["oa"] == pytest.approx(want["oa"], abs=OA_ATOL)
    assert got["rec_names"] == want["rec_names"]
    for k, v in want["results"].items():
        np.testing.assert_allclose(got["results"][k], v, atol=OA_ATOL, err_msg=k)


def check_infer(run):
    for split, (want, got) in run.infer.items():
        for key in ("raw_mean_oa", "viterbi_mean_oa"):
            assert got[key] == pytest.approx(want[key], abs=OA_ATOL), (split, key)
        for path in ("raw", "viterbi"):
            for k, v in want[path].items():
                np.testing.assert_allclose(got[path][k], v, atol=OA_ATOL, err_msg=f"{split} {path} {k}")


def check_calibration_modes(run):
    (ws, gs), (wh, gh), (wo, go) = (run.calib[m] for m in
                                    ("sweep-threshold", "hard-vs-auto", "sweep-obs"))
    assert gs["best_threshold"] == ws["best_threshold"]
    assert gs["best_oa_threshold"] == ws["best_oa_threshold"]
    for k in ("va", "oa"):
        np.testing.assert_allclose(gs[k], ws[k], atol=OA_ATOL)
    assert gh["auto_threshold"] == wh["auto_threshold"]
    for which in ("auto", "hard"):
        for k in ("raw_mean_oa", "viterbi_mean_oa"):
            assert gh[which][k] == pytest.approx(wh[which][k], abs=OA_ATOL)
    np.testing.assert_allclose(go["oa"], wo["oa"], atol=OA_ATOL)
    assert (go["best_p"], go["best_scale"]) == (wo["best_p"], wo["best_scale"])


@pytest.mark.parametrize("fam", HERE)
def test_train_steps_match_jax(fam):
    check_train_steps(family_run(fam))


@pytest.mark.parametrize("fam", HERE)
def test_validate_matches_jax(fam):
    check_validate(family_run(fam))


@pytest.mark.parametrize("fam", HERE)
def test_infer_matches_jax(fam):
    check_infer(family_run(fam))


@pytest.mark.parametrize("fam", HERE)
def test_calibration_modes_match_jax(fam):
    check_calibration_modes(family_run(fam))


def test_msnet_app_main_cycle(tmp_path, capsys, monkeypatch):
    """train (events, per-epoch train metrics and tables), --resume, infer
    with --dump-tracks and --log-dir, the calibration modes, infer
    --external-eval with no corpus root set, the refused --mesh: the port's
    msnet app on --synthetic --debug on the CPU."""
    from viterbi_spl_tpu_torch.apps import msnet

    ck, log = tmp_path / "ck.pt", tmp_path / "log"
    common = ["--synthetic", "--debug", "--device", "cpu", "--ckpt", str(ck)]
    state = msnet.main(["train", *common, "--epochs", "3", "--steps-per-epoch", "2",
                        "--patience", "5", "--log-dir", str(log)])
    assert 0 <= state.voicing_threshold <= 1 and state.best_oa > -1
    events = [json.loads(line) for line in (log / "events.jsonl").read_text().splitlines()]
    for tag in ("train_loss", "val_oa", "train_oa", "train_vrr", "train_vfa", "train_va",
                "train_rpa_strict"):
        vals = [e["value"] for e in events if e.get("tag") == tag]
        assert len(vals) == 3, tag  # one per epoch
        assert all(np.isfinite(vals)) and (tag == "train_loss" or all(0 <= x <= 1 for x in vals))
    ttables = [e for e in events if e.get("kind") == "text" and e.get("tag") == "train"]
    vtables = [e for e in events if e.get("kind") == "text" and e.get("tag") == "validation"]
    assert len(ttables) == 3 and len(vtables) == 3
    assert "| training |" in ttables[0]["text"] and "| vrr |" in ttables[0]["text"]
    assert "**average**" in vtables[0]["text"]
    ckpt, family, _ = restore_checkpoint(ck)
    assert family == "msnet" and ckpt.epoch == state.best_epoch and ckpt.step == 2 * (ckpt.epoch + 1)
    assert ckpt.opt_state["state"][0]["step"] == ckpt.step

    resumed = msnet.main(["train", *common, "--epochs", str(state.best_epoch + 2),
                          "--steps-per-epoch", "1", "--resume"])
    assert resumed.best_oa >= state.best_oa

    dump = tmp_path / "analysis"
    out = msnet.main(["infer", *common, "--dump-tracks", str(dump), "--log-dir", str(tmp_path / "il")])
    assert np.isfinite(out["validation"]["viterbi_mean_oa"]) and np.isfinite(out["test"]["raw_mean_oa"])
    assert list(dump.glob("*.png")) and list(dump.glob("*.npz"))
    assert "viterbi" in (tmp_path / "il" / "events.jsonl").read_text()
    sweep = msnet.main(["sweep-threshold", *common])
    assert len(sweep["thresholds"]) == len(sweep["oa"]) == 99 and 0 < sweep["best_threshold"] < 1
    hva = msnet.main(["hard-vs-auto", *common, "--hard-threshold", "0.5"])
    assert np.isfinite(hva["auto"]["viterbi_mean_oa"]) and np.isfinite(hva["hard"]["viterbi_mean_oa"])
    obs = msnet.main(["sweep-obs", *common])
    assert obs["oa"].shape == (4, 3) and np.all(np.isfinite(obs["oa"]))
    for corpus in ("adc04", "mirex05", "mir1k", "rwc"):
        monkeypatch.delenv(corpus, raising=False)
    capsys.readouterr()
    ext = msnet.main(["infer", *common, "--external-eval"])
    assert "--external-eval: no external corpus roots set (adc04/mirex05/mir1k/rwc)" \
        in capsys.readouterr().out
    assert [k for k in ext if k != "state"] == ["validation", "test"]
    assert ext["test"]["viterbi_mean_oa"] == out["test"]["viterbi_mean_oa"]
    with pytest.raises(SystemExit, match="queue 1 item 5, '--mesh training with dist/tp.py'"):
        msnet.main(["train", *common, "--mesh", "data=2"])


def test_tonet_main_backbone_checkpoint(tmp_path, monkeypatch):
    """TONet's --backbone and --mode reach the model and its checkpoint,
    which restores as cli/transcribe.py's loader restores it."""
    from viterbi_spl_tpu_torch.apps import tonet
    from viterbi_spl_tpu_torch.models.tonet import TONet

    wide = tonet.config
    monkeypatch.setattr(tonet, "config", lambda: dataclasses.replace(
        wide(), make_model=lambda **kw: TONet(**{"attn_dim": 32, **kw})))
    ck = tmp_path / "t.pt"
    state = tonet.main(["train", "--synthetic", "--debug", "--device", "cpu", "--ckpt", str(ck),
                        "--epochs", "1", "--steps-per-epoch", "1", "--backbone", "msnet",
                        "--mode", "spat"])
    assert state.step == 1
    ckpt, family, kw = restore_checkpoint(ck)
    assert family == "tonet" and kw == dict(backbone="msnet", mode="spat")
    out = tonet.main(["infer", "--synthetic", "--debug", "--device", "cpu", "--ckpt", str(ck),
                      "--backbone", "msnet", "--mode", "spat"])
    assert np.isfinite(out["test"]["viterbi_mean_oa"])
    cfg = tonet.config()
    with torch.device("meta"):
        model = cfg.make_model(dtype=cfg.compute_dtype, **kw)
    assert model.mode == "spat" and model.backbone == "msnet"
    TC.load_state(model.to_empty(device="cpu"), ckpt)  # as cli/transcribe.py loads it
