"""The port's training harness (viterbi_spl_tpu_torch/harness/, the training
layers of models/layers.py, the optimizer of apps/common.py,
scripts/orbax_to_torch.py's Adam state) against the JAX package's, on the
CPU; the template is tests/test_harness.py.

- Trainer: early stop + save on improvement + restore, resume that validates
  first, a `/1` checkpoint (no optimizer state) restores, the `threshold`
  introspection, the epoch's losses and counts read once.
- add_weight_decay_grad and l2_regularization equal the JAX ones.
- BatchNorm in training mode against flax's train=True on the same input:
  the output within 1e-5 of its largest value, the running averages within
  1e-6 (flax's one-pass variance against the port's two passes, on data
  with mean ~ std); Dropout's keep rate and 1 / (1 - rate) scale; fresh
  masks each step from apps/common.dropout_generator, the same masks for
  the same step.
- Adam (apps/common.py::ScheduledAdam) against optax.adam, with and without
  tonet's schedule, 5 updates of a 3-tensor problem: params within 1e-6
  relative (float32 arithmetic, sum orders).
- A JAX checkpoint (params and optax's Adam state after two JAX steps)
  converted by scripts/orbax_to_torch.py resumes in the port: the step
  after the resume equals the JAX step after its own resume (msnet, its
  dropouts none): loss within rtol 1e-5, Adam's count carried, the moments
  after the step within 1e-5 of each tensor's largest, the parameter
  update within 1e-6 absolute (lr 1e-4) where the gradient is clear of 0.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from test_torch_models import flax_variables
from viterbi_spl_tpu.apps import common as JC
from viterbi_spl_tpu.apps import msnet as j_msnet
from viterbi_spl_tpu.apps.tonet import tonet_lr_schedule as j_schedule
from viterbi_spl_tpu.data import training_snippets as j_training_snippets
from viterbi_spl_tpu.harness.train import Trainer as JTrainer
from viterbi_spl_tpu.harness.train import TrainState as JTrainState
from viterbi_spl_tpu.harness.train import add_weight_decay_grad as j_wd
from viterbi_spl_tpu.harness.train import l2_regularization as j_l2
from viterbi_spl_tpu_torch.apps import common as TC
from viterbi_spl_tpu_torch.apps import msnet as t_msnet
from viterbi_spl_tpu_torch.apps.tonet import tonet_lr_schedule
from viterbi_spl_tpu_torch.harness import (
    HarnessConfig,
    Reporter,
    TrainOrInference,
    Trainer,
    TrainState,
    metrics_markdown_table,
)
from viterbi_spl_tpu_torch.harness.train import (
    add_weight_decay_grad,
    l2_regularization,
    restore_checkpoint,
    split_state_dict,
)
from viterbi_spl_tpu_torch.models.convert import convert
from viterbi_spl_tpu_torch.models.layers import BatchNorm, Dropout

ROOT = Path(__file__).resolve().parent.parent


def _tiny_trainer(tmp_path, target_w=3.0):
    """1-parameter linear model trained by SGD to fit y = target_w * x."""
    w = torch.nn.Parameter(torch.tensor(1.0))
    opt = torch.optim.SGD([w], lr=0.1)

    def train_step(params, batch_stats, opt_state, batch, step):
        x, y = batch
        opt_state.zero_grad()
        loss = torch.mean((params["w"] * x - y) ** 2)
        loss.backward()
        opt_state.step()
        return params, batch_stats, opt_state, loss.detach()

    def batches():
        rng = np.random.default_rng(0)
        while True:
            x = torch.from_numpy(rng.normal(size=8).astype(np.float32))
            yield x, target_w * x

    def validate(state):
        # "oa" improves as w approaches the target
        return dict(oa=1.0 - abs(state.params["w"].item() - target_w), voicing_threshold=0.4)

    state = TrainState(params={"w": w}, batch_stats={}, opt_state=opt)
    trainer = Trainer(train_step, validate, ckpt_path=tmp_path / "ckpt.pt",
                      patience_epochs=3, max_epochs=50, family="tiny")
    return trainer, state, batches()


def test_training_loop_early_stop_and_checkpoint(tmp_path):
    trainer, state, batches = _tiny_trainer(tmp_path)
    state = trainer.fit(state, batches, steps_per_epoch=5)
    assert state.best_oa > 0.95
    assert state.voicing_threshold == pytest.approx(0.4)
    assert state.epoch < 50  # early stopping fired
    assert state.epoch - state.best_epoch == 3
    # restore brings back the best (checkpointed) weights into the live ones
    with torch.no_grad():
        state.params["w"].fill_(-7.0)
    restored = trainer.restore(state)
    assert restored.params["w"] is state.params["w"]
    assert float(restored.params["w"]) == pytest.approx(3.0, abs=0.1)
    assert restored.best_oa == pytest.approx(state.best_oa)
    assert restored.best_epoch == state.best_epoch
    ck, family, _ = restore_checkpoint(trainer.ckpt_path)
    assert family == "tiny" and ck.opt_state["param_groups"][0]["lr"] == 0.1


def test_fit_reports_each_epochs_steps_and_seconds(tmp_path):
    """on_epoch_end's info holds the epoch's steps and their seconds (the
    event log's train_steps and train_step_seconds), and the Trainer keeps
    the last epoch's; the steps sum to the state's step counter."""
    trainer, state, batches = _tiny_trainer(tmp_path)
    infos = []
    state = trainer.fit(state, batches, steps_per_epoch=5,
                        on_epoch_end=lambda st, info: infos.append(info))
    assert [i["train_steps"] for i in infos] == [5] * len(infos)
    assert sum(i["train_steps"] for i in infos) == state.step
    assert all(i["train_step_seconds"] > 0 for i in infos)
    assert (trainer.last_epoch_steps, trainer.last_epoch_seconds) == (
        infos[-1]["train_steps"], infos[-1]["train_step_seconds"])


def test_training_resume_validates_first(tmp_path):
    trainer, state, batches = _tiny_trainer(tmp_path)
    state = trainer.fit(state, batches, steps_per_epoch=2)
    best_w = float(restore_checkpoint(trainer.ckpt_path)[0].params["w"])
    trainer2, state2, batches2 = _tiny_trainer(tmp_path)
    seen = []
    inner = trainer2.validate

    def validate(st):
        seen.append((st.epoch, float(st.params["w"])))
        return inner(st)

    trainer2.validate = validate
    trainer2.max_epochs = state.best_epoch + 2
    resumed = trainer2.fit(state2, batches2, steps_per_epoch=1, resume=True)
    # the first validation ran on the restored weights, before any step
    assert seen[0] == (state.best_epoch, best_w)
    assert resumed.best_oa >= state.best_oa - 1e-6


def test_restore_checkpoint_format_1(tmp_path):
    """A `/1` file (the state and scalars, no optimizer state, as the port
    wrote before it trained) restores; the optimizer keeps its own state."""
    trainer, state, batches = _tiny_trainer(tmp_path)
    state = trainer.fit(state, batches, steps_per_epoch=2)
    torch.save(dict(format="viterbi_spl_tpu_torch.checkpoint/1", family="tiny", model_kwargs={},
                    params={"w": torch.tensor(2.5)}, batch_stats={},
                    scalars=dict(voicing_threshold=0.3, epoch=4, best_oa=0.5, best_epoch=2,
                                 step=9)), trainer.ckpt_path)
    ck, family, kw = restore_checkpoint(trainer.ckpt_path)
    assert ck.opt_state is None and family == "tiny" and kw == {}
    before = state.opt_state.state_dict()
    restored = trainer.restore(state)
    assert float(restored.params["w"]) == 2.5
    assert (restored.epoch, restored.best_epoch, restored.step) == (4, 2, 9)
    assert restored.opt_state.state_dict() == before
    with pytest.raises(ValueError, match="not a"):
        torch.save({"format": "viterbi_spl_tpu_torch.checkpoint/0"}, tmp_path / "old.pt")
        restore_checkpoint(tmp_path / "old.pt")


def test_trainer_step_introspection(tmp_path):
    """The metrics-reporting train step is detected by a parameter named
    `threshold`; variadic or extra-default-arg steps stay on the 5-arg
    protocol."""

    def legacy(params, bs, opt, batch, step):
        pass

    def with_threshold(params, bs, opt, batch, step, threshold):
        pass

    def variadic(*args):
        pass

    def extra_default(params, bs, opt, batch, step, rng_seed=0):
        pass

    def mk(f):
        return Trainer(f, lambda s: {"oa": 0.0}, ckpt_path=tmp_path / "ck.pt")

    assert not mk(legacy)._step_takes_threshold
    assert mk(with_threshold)._step_takes_threshold
    assert not mk(variadic)._step_takes_threshold
    assert not mk(extra_default)._step_takes_threshold


def test_epoch_counts_summed_and_read_once(tmp_path):
    """A 6-arg step's counts are summed over the epoch into the training
    metrics at the threshold it was given."""
    def step_fn(params, bs, opt, batch, step, threshold):
        counts = dict(voiced=torch.tensor(3), unvoiced=torch.tensor(1),
                      correct_voiced=torch.tensor([2]), incorrect_voiced=torch.tensor([1]),
                      correct_unvoiced=torch.tensor([0]), correct_pitches_wide=torch.tensor(2),
                      correct_pitches_strict=torch.tensor([1]),
                      correct_chromas_wide=torch.tensor(2),
                      correct_chromas_strict=torch.tensor([1]))
        return params, bs, opt, torch.tensor(float(step)), counts

    trainer = Trainer(step_fn, lambda s: {"oa": 0.0}, ckpt_path=tmp_path / "ck.pt")
    state = TrainState({}, {}, voicing_threshold=0.3)
    state, loss, tm = trainer.train_epoch(state, iter(range(4)), 4)
    assert loss == pytest.approx(1.5) and state.step == 4
    assert tm["vrr"] == pytest.approx(8 / 12) and tm["oa"] == pytest.approx(4 / 16)


def test_weight_decay_and_l2_match_jax(rng):
    w = rng.normal(size=(3, 4)).astype(np.float32)
    g = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    jg = j_wd({"a": {"kernel": jnp.asarray(g)}, "b": jnp.asarray(b)},
              {"a": {"kernel": jnp.asarray(w)}, "b": jnp.zeros(5)}, ("a", "kernel"), 2e-4)
    tg = add_weight_decay_grad({"a.weight": torch.from_numpy(g), "b": torch.from_numpy(b)},
                               {"a.weight": torch.from_numpy(w), "b": torch.zeros(5)},
                               "a.weight", 2e-4)
    np.testing.assert_array_equal(tg["a.weight"].numpy(), np.asarray(jg["a"]["kernel"]))
    np.testing.assert_array_equal(tg["b"].numpy(), np.asarray(jg["b"]))  # untouched
    reg_j = float(j_l2({"a": {"kernel": jnp.asarray(w)}, "c": {"kernel": jnp.asarray(g)}},
                       (("a", "kernel"), ("c", "kernel")), 1e-5))
    reg_t = float(l2_regularization({"a.weight": torch.from_numpy(w), "c.weight": torch.from_numpy(g)},
                                    ("a.weight", "c.weight"), 1e-5))
    assert reg_t == pytest.approx(reg_j, rel=1e-6)


def test_batchnorm_training_matches_flax(rng):
    """model.train(): the batch's statistics, and the running averages
    updated with flax's momentum 0.99 and biased variance."""
    x = (rng.normal(size=(4, 6, 5, 7)) * 2 + 1).astype(np.float32)  # NCHW
    scale, bias = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    mean, var = rng.normal(size=6).astype(np.float32), (1 + rng.random(6)).astype(np.float32)
    bn_j = nn.BatchNorm(use_running_average=False)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    y_j, upd = bn_j.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": mean, "var": var}}, xj, mutable=["batch_stats"])
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean))
        bn.var.copy_(torch.from_numpy(var))
    y = bn.train()(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(y_j)
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    # eval mode with batch statistics leaves the averages as they are
    m = bn.mean.clone()
    bn.eval()(torch.from_numpy(x), batch_stats=True)
    assert torch.equal(bn.mean, m)


def test_dropout_rate_scale_and_fresh_masks():
    drop = Dropout(0.2).train()
    x = torch.ones(200_000)
    y = drop(x, TC.dropout_generator(0, "cpu"))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    assert torch.allclose(y[kept], torch.tensor(1 / 0.8))
    assert torch.equal(drop(x), x)  # no generator: off
    assert torch.equal(drop.eval()(x, TC.dropout_generator(0, "cpu")), x)  # eval: off
    drop.train()
    again = drop(x, TC.dropout_generator(0, "cpu"))
    other = drop(x, TC.dropout_generator(1, "cpu"))
    assert torch.equal(again, y) and not torch.equal(other, y)


def test_train_step_dropout_masks_vary_per_step():
    """The app train step draws fresh dropout masks every step, the same
    masks for the same step (the JAX test_harness's check, on the port)."""

    class DropNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(1))
            self.bn = BatchNorm(8)
            self.drop = Dropout(0.5)

        def forward(self, x, batch_stats=False, dropout=None):
            return self.drop(self.bn(x * self.w), dropout)

    model = DropNet()
    cfg = TC.AppConfig(family=None, make_model=None,
                       loss_fn=lambda notes, out: torch.sum(out * notes),
                       logits_adapter=None, snippet_len=64, batch_size=1,
                       learning_rate=0.0, feature_shape=(64,))
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step_fn = TC.make_train_step(cfg, model)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 8, 16)).astype(np.float32))
    notes = torch.linspace(0.5, 1.5, 4 * 8 * 16).reshape(4, 8, 16)
    params, bs = split_state_dict(model)
    losses = [float(step_fn(params, bs, opt, (x, notes), s, 0.5)[3]) for s in (0, 1, 0)]
    assert losses[0] != losses[1], "dropout mask identical across steps"
    assert losses[0] == losses[2], "dropout mask not reproducible per step"


@pytest.mark.parametrize("scheduled", [False, True])
def test_adam_matches_optax(rng, scheduled):
    """ScheduledAdam = optax.adam (b1 0.9, b2 0.999, eps 1e-8), its lr of
    update k schedule(k) from Adam's own count."""
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    if scheduled:
        tx = optax.adam(j_schedule(1e-2, 2))
        t_sched = tonet_lr_schedule(1e-2, 2)
    else:
        tx = optax.adam(1e-2)

        def t_sched(k):
            return 1e-2
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = TC.ScheduledAdam(tp, t_sched)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    assert opt.update_count() == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_tonet_lr_schedule_equals_jax():
    for spe in (1, 7, 10):
        j, t = j_schedule(1e-4, spe), tonet_lr_schedule(1e-4, spe)
        for k in range(301):
            assert t(k) == float(j(k)), (spe, k)


def test_config_and_reporting(tmp_path, rng):
    cfg = HarnessConfig(mode=TrainOrInference(ckpt_prefix="x"), log_dir=str(tmp_path / "runs"),
                        ckpt_dir=str(tmp_path / "ckpts"))
    cfg.check_collisions()
    (tmp_path / "runs" / "x").mkdir(parents=True)
    with pytest.raises(FileExistsError):
        cfg.check_collisions()
    assert HarnessConfig(debug=True).truncate_split(list("abcdefg")) == ["a", "b"]
    results = {m: np.asarray([0.5, 0.75]) for m in
               ("vrr", "vfa", "va", "rpa_strict", "rpa_wide", "rca_strict", "rca_wide", "oa")}
    from viterbi_spl_tpu.harness.reporting import metrics_markdown_table as j_table

    assert metrics_markdown_table(results, ["t1", "t2"]) == j_table(results, ["t1", "t2"])
    with Reporter(tmp_path / "log") as rep:
        rep.scalar("loss", 1.5, step=0)
        rep.table("metrics", results, ["t1", "t2"])
    events = rep.read_events()
    assert events[0]["kind"] == "scalar" and "0.7500" in events[1]["text"]
    from viterbi_spl_tpu_torch.harness.reporting import dump_track_npz, piano_roll_figure

    notes = np.where(rng.random(50) > 0.3, 60.0, 0.0)
    piano_roll_figure(tmp_path / "roll.png", notes, notes, notes > 0, notes, notes > 0, title="t")
    dump_track_npz(tmp_path / "t.npz", ref_notes=notes)
    assert (tmp_path / "roll.png").stat().st_size > 0
    np.testing.assert_array_equal(np.load(tmp_path / "t.npz")["ref_notes"], notes)


def _load_converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", ROOT / "scripts" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resume_from_jax_checkpoint_equals_jax_step(tmp_path):
    """Two JAX msnet steps, the JAX checkpoint (Adam's state included)
    converted by scripts/orbax_to_torch.py; then the third step on both
    sides from their own restored states (see the module docstring)."""
    jcfg = dataclasses.replace(j_msnet.config(), batch_size=1)
    tcfg = t_msnet.config()
    train = JC.synthetic_dataset(jcfg, 2, 96, 0)
    rng = np.random.default_rng(0)
    snippets = j_training_snippets(train, jcfg.snippet_len, rng)
    batches = [next(snippets) for _ in range(3)]
    batches = [(i["spectrogram"][None], i["notes"][None]) for i in batches]

    jm = jcfg.make_model(dtype=jnp.float32)
    v = flax_variables(jm, batches[0][0], seed=4)
    tx = JC.make_optimizer(jcfg, 8)
    step = JC.make_train_step(jcfg, jm, tx)
    params, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])
    for s in range(2):
        params, bs, opt, _, _ = step(params, bs, opt, tuple(map(jnp.asarray, batches[s])), s, 0.5)
    state = JTrainState(params=params, batch_stats=bs, opt_state=opt, voicing_threshold=0.4,
                        epoch=1, best_oa=0.1, best_epoch=1, step=2)
    JTrainer(None, None, ckpt_path=str(tmp_path / "jax_ckpt")).save(state)
    # the JAX resume: its own restore, then step 2
    restored = JTrainer(None, None, ckpt_path=str(tmp_path / "jax_ckpt")).restore(state)
    jp, jbs, jopt, jl, _ = step(restored.params, restored.batch_stats, restored.opt_state,
                                tuple(map(jnp.asarray, batches[2])), restored.step, 0.5)

    pt = tmp_path / "msnet.pt"
    _load_converter().main(["--family", "msnet", str(tmp_path / "jax_ckpt"), str(pt)])
    model, p, b = TC.init_model(tcfg, seed=9)
    topt = TC.make_optimizer(tcfg, model, 8)
    trainer = Trainer(TC.make_train_step(tcfg, model), None, ckpt_path=pt, family="msnet")
    ts = trainer.restore(TrainState(p, b, opt_state=topt))
    assert ts.step == 2 and topt.update_count() == 2
    before = {k: t.detach().clone() for k, t in p.items()}
    *_, tl, _ = trainer.train_step(ts.params, ts.batch_stats, ts.opt_state,
                                   tuple(map(torch.from_numpy, batches[2])), ts.step, 0.5)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert topt.update_count() == 3
    host = jax.tree_util.tree_map(np.asarray, dict(p=jp, mu=jopt[0].mu, nu=jopt[0].nu,
                                                   bs=jbs))
    want_p, _ = convert("msnet", host["p"], host["bs"])
    mu, _ = convert("msnet", host["mu"], host["bs"])
    nu, _ = convert("msnet", host["nu"], host["bs"])
    for i, (k, t) in enumerate(p.items()):
        st = topt.state[t]
        for got, want in ((st["exp_avg"], mu[k]), (st["exp_avg_sq"], nu[k])):
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), k
        clear = mu[k].abs() > 1e-2 * mu[k].abs().max()
        d_port, d_jax = t.detach() - before[k], want_p[k] - before[k]
        assert float(((d_port - d_jax).abs() * clear).max()) <= 1e-6, k


def test_bf16_train_step_keeps_f32_params():
    """`--bf16` training (tests/test_precision.py:66's template): a msnet
    train step through make_train_step with compute_dtype bfloat16 runs its
    convolutions in bfloat16, has a finite loss, and its gradients,
    BatchNorm statistics and params stay float32 (the statistics updated by
    the step)."""
    cfg = dataclasses.replace(t_msnet.config(), compute_dtype=torch.bfloat16)
    model, params, stats = TC.init_model(cfg, seed=0, device="cpu")
    opt = TC.make_optimizer(cfg, model, 8)
    step = TC.make_train_step(cfg, model)
    from viterbi_spl_tpu_torch.models.layers import Conv

    conv_dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: conv_dtypes.add(o.dtype))
             for m in model.modules() if isinstance(m, Conv)]
    x = torch.randn((2, 8, 320, 3), generator=torch.Generator().manual_seed(0))
    notes = torch.from_numpy(np.where(np.arange(8) % 3 == 0, 0.0, 60.0).astype(np.float32))
    before = {k: p.detach().clone() for k, p in params.items()}
    stats_before = {k: v.clone() for k, v in stats.items()}
    _, new_stats, _, loss, _ = step(params, stats, opt, (x, notes.expand(2, 8)), 0, 0.5)
    for h in hooks:
        h.remove()
    assert conv_dtypes == {torch.bfloat16}
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    for k, p in params.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k
    assert any(not torch.equal(p, before[k]) for k, p in params.items())
    assert all(v.dtype == torch.float32 for v in new_stats.values())
    assert any(not torch.equal(v, stats_before[k]) for k, v in new_stats.items())
