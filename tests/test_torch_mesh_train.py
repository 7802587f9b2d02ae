"""`train --mesh data=N[,model=M]` in the port (apps/common.py,
dist/train.py, dist/tp.py, models/layers.py's data shares) against the
single-device run and the JAX package, on CPU meshes (["cpu"] * n); the
templates are tests/test_apps.py:172-250 and tests/test_dist.py:214-250.

- Malformed --mesh values, and too few CUDA devices, exit with SystemExit.
- msnet (batch 4, 50-frame snippets: whole snippets, the same batch
  stream) with --mesh data=4 and data=2,model=2 gives the single-device
  loss curve at rtol 1e-4 (the JAX test's bound: sum orders), and so does
  --mesh data=2 with --native-prefetch.
- BatchNorm over 2 and 4 shares equals one batch: the output and the
  input's gradient within 1e-5 of their largest, the batch mean and
  variance and every replica's running averages within 1e-6, the scale
  and bias gradients summed over the replicas within 1e-5; Dropout's masks
  under a mesh equal the single run's (and a process's two shares of four
  take rows 4-7 of the global mask).
- The leaves the port shards under model=M (M = 2, 4) are exactly those
  the JAX package's tp_spec shards on the flax tree, matched through
  convert, for every NN family (no compile: eval_shape).
- tp_shard_tree's placement, and unchanged values.
- One msnet step from converted JAX params on a data=2,model=2 mesh equals
  the JAX single-device step at
  test_torch_train.py::test_resume_from_jax_checkpoint_equals_jax_step's
  tolerances (loss rtol 1e-5, Adam's moments within 1e-5 of each tensor's
  largest, the update within 1e-6 where the gradient is clear of 0), the
  moments read back through the mesh optimizer's unsharded state_dict.
- A --mesh data=2,model=2 checkpoint holds the single-device layout and
  restores into a single-device infer; --resume with --mesh re-splits it.

PyTorch runs on one thread (tests/torch_threads.py).
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import flax_variables
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.apps import common as JC
from viterbi_spl_tpu.apps import msnet as j_msnet
from viterbi_spl_tpu.dist import tp_spec as j_tp_spec
from viterbi_spl_tpu.models.dcnet import DCNet as JDCNet
from viterbi_spl_tpu.models.ftanet import FTANet as JFTANet
from viterbi_spl_tpu.models.jdc import JDC as JJDC
from viterbi_spl_tpu.models.msnet import MSNet as JMSNet
from viterbi_spl_tpu.models.tonet import TONet as JTONet
from viterbi_spl_tpu_torch.apps import common as TC
from viterbi_spl_tpu_torch.apps import msnet as t_msnet
from viterbi_spl_tpu_torch.dist.mesh import make_mesh, mesh_device_list
from viterbi_spl_tpu_torch.dist.tp import make_tp_mesh, tp_param_specs, tp_shard_tree
from viterbi_spl_tpu_torch.dist.train import MeshOptimizer, ShareGroup
from viterbi_spl_tpu_torch.harness.train import restore_checkpoint
from viterbi_spl_tpu_torch.models import DCNet, FTANet, JDC, MSNet, TONet
from viterbi_spl_tpu_torch.models.convert import convert
from viterbi_spl_tpu_torch.models.layers import BatchNorm, Dropout


def _cfg():
    # 50 divides the 400-frame debug tracks: whole snippets only, so that
    # every run draws the same batch stream
    return dataclasses.replace(t_msnet.config(), batch_size=4, snippet_len=50)


def _train(tmp_path, tag, extra=(), epochs=2):
    log = tmp_path / f"log_{tag}"
    state = TC.app_main(_cfg(), None, [
        "train", "--synthetic", "--debug", "--device", "cpu", "--epochs", str(epochs),
        "--steps-per-epoch", "3", "--patience", "3", "--ckpt", str(tmp_path / f"ck_{tag}.pt"),
        "--log-dir", str(log), *extra])
    events = [json.loads(line) for line in (log / "events.jsonl").read_text().splitlines()]
    return state, [e["value"] for e in events
                   if e.get("kind") == "scalar" and e.get("tag") == "train_loss"]


@pytest.fixture(scope="module")
def single_losses(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("single"), "single")[1]


def test_mesh_flag_malformed_values_exit_cleanly(tmp_path, monkeypatch):
    cfg = dataclasses.replace(t_msnet.config(), batch_size=2)
    for bad in ("4", "data=abc", "data", "data=2,pipe=2", "data=0"):
        with pytest.raises(SystemExit, match="--mesh"):
            TC.app_main(cfg, None, ["train", "--synthetic", "--debug", "--device", "cpu",
                                    "--ckpt", str(tmp_path / "ck.pt"), "--mesh", bad])
    # too few CUDA devices: an exit naming the count, never a run on the CPU
    with pytest.raises(SystemExit, match="only 0 CUDA devices"):
        mesh_device_list(2, "cuda", "--mesh data=2,model=1")
    monkeypatch.setattr(TC, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"--mesh data=2,model=1: only 1 CUDA devices"):
        TC.app_main(cfg, None, ["train", "--synthetic", "--debug", "--mesh", "data=2"])


@pytest.mark.parametrize("mesh,extra", [("data=4", ()), ("data=2,model=2", ()),
                                        ("data=2", ("--native-prefetch",))],
                         ids=["data4", "data2_model2", "data2_native_prefetch"])
def test_mesh_training_matches_single_device(tmp_path, single_losses, mesh, extra):
    """tests/test_apps.py:192 and :232: the mesh reproduces the single-device
    loss curve at the same global batch."""
    _, losses = _train(tmp_path, "mesh", ("--mesh", mesh, *extra))
    assert len(single_losses) == 2
    np.testing.assert_allclose(losses, single_losses, rtol=1e-4)


def test_mesh_raises_batch_and_needs_full_snippets(tmp_path, capsys):
    """A batch size that does not divide is raised, with the JAX app's line;
    a corpus with no full-length snippet exits (msnet's 1,200 frames over
    400-frame --debug tracks)."""
    cfg = dataclasses.replace(_cfg(), batch_size=3)
    TC.app_main(cfg, None, ["train", "--synthetic", "--debug", "--device", "cpu", "--epochs", "1",
                            "--steps-per-epoch", "1", "--ckpt", str(tmp_path / "a.pt"),
                            "--mesh", "data=2"])
    assert "--mesh data=2: raising batch size 3 -> 4 (must divide evenly)" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit, match="no track has 1200 frames"):
        t_msnet.main(["train", "--synthetic", "--debug", "--device", "cpu", "--ckpt",
                      str(tmp_path / "b.pt"), "--mesh", "data=2"])


# ---- BatchNorm and Dropout across data shares -------------------------------


def _shares(x, n):
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b] for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_across_shares_equals_one_batch(rng, n):
    x = (rng.normal(size=(8, 6, 5, 3)) * 2 + 1).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.normal(1, 0.1, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32)))
    single, reps = copy.deepcopy(bn).train(), [copy.deepcopy(bn).train() for _ in range(n)]

    x1 = torch.tensor(x, requires_grad=True)
    y1 = single(x1)
    (y1 * torch.from_numpy(w)).sum().backward()

    x2 = torch.tensor(x, requires_grad=True)
    group = ShareGroup(["cpu"] * n, size=n)
    outs = group.run(lambda i, xi: reps[i](xi), _shares(x2, n))
    sum((o * wi).sum() for o, wi in zip(outs, _shares(torch.from_numpy(w), n))).backward()

    y2 = torch.cat(outs)
    y1, y2 = y1.detach(), y2.detach()
    assert float((y2 - y1).abs().max()) <= 1e-5 * float(y1.abs().max())
    assert float((x2.grad - x1.grad).abs().max()) <= 1e-5 * float(x1.grad.abs().max())
    for name in ("scale", "bias"):
        got = sum(getattr(r, name).grad for r in reps)
        want = getattr(single, name).grad
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
    mu = x.mean(axis=(0, 2, 3))
    var = ((x - mu[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    for r in reps:
        # every replica moved its averages by the global mean and variance
        assert torch.equal(r.mean, reps[0].mean) and torch.equal(r.var, reps[0].var)
        np.testing.assert_allclose(r.mean.numpy(), single.mean.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r.var.numpy(), single.var.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r.mean.numpy() / 0.01, mu, rtol=1e-4)
        np.testing.assert_allclose((r.var.numpy() - 0.99) / 0.01, var, rtol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_dropout_masks_under_a_mesh_equal_the_single_run(n):
    x = torch.ones(8, 3, 5)
    drop = Dropout(0.3).train()
    want = drop(x, TC.dropout_generator(7, "cpu"))
    group = ShareGroup(["cpu"] * n, size=n)
    got = group.run(lambda i, xi: drop(xi, TC.dropout_generator(7, "cpu")), _shares(x, n))
    assert torch.equal(torch.cat(got), want)
    # a process whose two shares are shares 2 and 3 of four
    group = ShareGroup(["cpu"] * 2, size=4, first=2)
    got = group.run(lambda i, xi: drop(xi, TC.dropout_generator(7, "cpu")), _shares(x[4:], 2))
    assert torch.equal(torch.cat(got), want[4:])


# ---- the tp rule against the JAX package's -----------------------------------

FAMILIES = [
    ("msnet", JMSNet, MSNet, (1, 8, 320, 3)),
    ("ftanet", JFTANet, FTANet, (1, 8, 320, 3)),
    ("jdc", JJDC, JDC, (1, 31, 513)),
    ("tonet", lambda: JTONet(attn_dim=32), TONet, (1, 3, 360, 8)),
    ("dcnet", JDCNet, DCNet, (1, 8, 500)),
]


def _marked(variables):
    """Each flax leaf filled with its own marker 1, 2, ... -> (marked
    variables, {marker: (path, shape)})."""
    where = {}

    def mark(path, leaf):
        k = len(where) + 1
        where[k] = (jax.tree_util.keystr(path), tuple(leaf.shape))
        return np.full(leaf.shape, k, np.float32)

    return jax.tree_util.tree_map_with_path(mark, variables), where


@pytest.mark.parametrize("family,jcls,tcls,shape", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_tp_shard_set_equals_jax(family, jcls, tcls, shape):
    x = np.zeros(shape, np.float32)
    shapes = jax.eval_shape(lambda: jcls().init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                train=False))
    variables, where = _marked(dict(shapes))
    sd, kw = convert(family, variables["params"], variables.get("batch_stats", {}))
    with torch.device("meta"):
        model = tcls(**kw)
    assert set(sd) == set(model.state_dict())
    sources = {name: sorted(set(np.unique(t.numpy()).astype(int)) - {0})
               for name, t in sd.items()}
    assert sorted(k for s in sources.values() for k in s) == sorted(where), \
        "every flax leaf lands in one port tensor"
    for m in (2, 4):
        specs = tp_param_specs(model, m)
        for name, src in sources.items():
            if not src:  # nn.LSTM's bias_ih, zero: no flax leaf; it follows its weight_ih
                assert "bias_ih" in name
                assert (specs[name] is None) == (specs[name.replace("bias", "weight")] is None)
                continue
            want = {j_tp_spec(where[k][1], m) != jax.sharding.PartitionSpec() for k in src}
            assert want == {specs[name] is not None}, (family, m, name,
                                                       [where[k] for k in src])


def test_tp_shard_tree_places_leaves():
    """tests/test_dist.py:231 on a 4 x 2 CPU mesh."""
    mesh = make_tp_mesh(4, 2, [torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    tree = {"conv.weight": torch.randn(16, 8, 3, 3), "conv.bias": torch.randn(16),
            "head.weight": torch.randn(361, 16), "count": torch.zeros(())}
    sharded = tp_shard_tree(tree, mesh)
    assert [s.shape for s in sharded["conv.weight"].shards] == [(8, 8, 3, 3)] * 2
    assert [s.shape for s in sharded["conv.bias"].shards] == [(8,)] * 2
    assert sharded["head.weight"].spec is None and len(sharded["head.weight"].shards) == 1
    assert sharded["count"].spec is None
    for name, t in tree.items():
        assert torch.equal(sharded[name].full("cpu"), t), name
    # nn.LSTM: each shard holds its slice of every gate
    lstm = torch.nn.LSTM(4, 6, batch_first=True)
    specs = tp_param_specs(lstm, 2)
    assert specs["weight_ih_l0"].groups == 4
    tree = dict(lstm.state_dict())
    sharded = tp_shard_tree(tree, mesh, specs)
    w = tree["weight_ih_l0"]
    assert torch.equal(sharded["weight_ih_l0"].shards[1],
                       torch.cat([w[g * 6 + 3:g * 6 + 6] for g in range(4)]))
    assert torch.equal(sharded["weight_ih_l0"].full("cpu"), w)


# ---- the JAX step, and the checkpoint ---------------------------------------


def test_tp_step_from_jax_params_equals_jax_step():
    jcfg = dataclasses.replace(j_msnet.config(), batch_size=2)
    tcfg = dataclasses.replace(t_msnet.config(), batch_size=2)
    train = JC.synthetic_dataset(jcfg, 2, 96, 0)
    batch = (np.stack([train[i].spectrogram for i in range(2)]),
             np.stack([train[i].notes for i in range(2)]))
    jm = jcfg.make_model(dtype=jnp.float32)
    v = flax_variables(jm, batch[0], seed=4)
    tx = JC.make_optimizer(jcfg, 8)
    jp, jbs, jopt, jl, _ = JC.make_train_step(jcfg, jm, tx)(
        v["params"], v["batch_stats"], tx.init(v["params"]), tuple(map(jnp.asarray, batch)), 0,
        0.5)

    sd, _ = convert("msnet", v["params"], v["batch_stats"])
    model, params, stats = TC.init_model(tcfg, seed=9)
    model.load_state_dict(sd, strict=True)
    before = {k: t.detach().clone() for k, t in params.items()}
    mesh = make_tp_mesh(2, 2, ["cpu"] * 4)
    opt = MeshOptimizer(model, mesh, lambda ps: TC.make_optimizer(tcfg, None, 8, params=ps))
    assert any(sh.spec is not None for sh in opt.store.values())
    tl = TC.make_mesh_train_step(tcfg, opt)(params, stats, opt, tuple(map(torch.from_numpy,
                                                                          batch)), 0, 0.5)[3]
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert opt.update_count() == 1
    host = jax.tree_util.tree_map(np.asarray, dict(p=jp, mu=jopt[0].mu, nu=jopt[0].nu, bs=jbs))
    want_p, _ = convert("msnet", host["p"], host["bs"])
    mu, _ = convert("msnet", host["mu"], host["bs"])
    nu, _ = convert("msnet", host["nu"], host["bs"])
    state = opt.state_dict()
    for i, (k, t) in enumerate(params.items()):
        st = state["state"][i]
        assert int(st["step"]) == 1
        for got, want in ((st["exp_avg"], mu[k]), (st["exp_avg_sq"], nu[k])):
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), k
        clear = mu[k].abs() > 1e-2 * mu[k].abs().max()
        d_port, d_jax = t.detach() - before[k], want_p[k] - before[k]
        assert float(((d_port - d_jax).abs() * clear).max()) <= 1e-6, k
    for k, t in stats.items():  # the BatchNorm averages, from the global batch
        np.testing.assert_allclose(t.numpy(), want_p[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_mesh_checkpoint_restores_single_device_and_resumes_on_mesh(tmp_path):
    """The --mesh data=2,model=2 checkpoint: the single-device layout (Adam's
    state over the model's params, whole tensors), read by a single-device
    infer; --resume with the mesh re-splits it and trains on."""
    state, _ = _train(tmp_path, "tp", ("--mesh", "data=2,model=2"), epochs=1)
    ck, family, _ = restore_checkpoint(tmp_path / "ck_tp.pt")
    model, params, _ = TC.init_model(_cfg(), seed=0)
    assert family == "msnet" and set(ck.params) == set(params)
    opt_sd = ck.opt_state
    assert sorted(opt_sd["state"]) == list(range(len(params)))
    assert opt_sd["param_groups"][0]["params"] == list(range(len(params)))
    for i, (name, t) in enumerate(params.items()):
        assert opt_sd["state"][i]["exp_avg"].shape == t.shape, name
        assert int(opt_sd["state"][i]["step"]) == ck.step == 3
    common = ["--synthetic", "--debug", "--device", "cpu", "--ckpt", str(tmp_path / "ck_tp.pt")]
    cfg = _cfg()
    out = TC.app_main(cfg, None, ["infer", *common])
    assert np.isfinite(out["test"]["viterbi_mean_oa"])
    for name, t in out["state"].params.items():
        assert torch.equal(t, ck.params[name]), name
    resumed = TC.app_main(cfg, None, ["train", *common, "--epochs", "2", "--steps-per-epoch", "1",
                                      "--resume", "--mesh", "data=2,model=2"])
    # two more steps; the best epoch's checkpoint comes back, with its Adam count
    assert resumed.step in (4, 5) and resumed.opt_state.update_count() == resumed.step
