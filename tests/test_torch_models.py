"""The port's models (viterbi_spl_tpu_torch/models/) against the JAX
package's flax models on the CPU: the same seeded inputs, the weights
carried across by models/convert.py.

The flax weights come from the model's own param tree (jax.eval_shape of
its init, so every name and shape is flax's) filled with seeded NumPy
values: kernels ~ N(0, 1/fan_in), biases and norm offsets ~ N(0, 0.1^2),
norm scales ~ 1 + N(0, 0.1^2), BatchNorm running means ~ N(0, 0.1^2) and
variances ~ 1 + |N(0, 0.1^2)|. (flax's init compiles for about a minute on
the CPU even at TONet's narrowest width; its values are not what is under
test.) Widths are narrow (TONet attn_dim 32) and inputs short (8 frames
where the model takes any length), except where the architecture fixes
them (360/320 bins, jdc's 513 bins and 31 frames).

Tolerances and where they come from:
- eval mode (running averages), float32: max |diff| <= 1e-4 * max|JAX|
  (conv and matmul sum orders, a few ulps a layer).
- batch statistics (the apps' eval_batch_stats) for ftanet and TONet:
  against the JAX model run in float64, atol 2e-3 * max|JAX|: the port's
  float32 sum orders, which the batch-statistics normalization of a few
  chunks amplifies. Not against JAX in float32: flax 0.12's
  BatchNorm takes the variance as E[x^2] - E[x]^2, which cancels in the
  SF modules' normalization of chunk means across a batch (its float32
  output 0.012 off float64 on such means, scripts/precision_probe.py);
  the port takes the two-pass variance (models/layers.py), so float64 is
  the reference that tells the two apart. TONet's batch-stat
  forward in the JAX package also runs its dropouts (train=True with a
  fixed key); the port runs none, and the JAX side here has its Dropout
  layers intercepted to the identity.
- batch statistics for msnet and jdc, against JAX float32: the eval bound.
- bfloat16 compute (--bf16): relative L2 error against the JAX package's
  bfloat16 logits below the per-model bound of
  tests/test_precision.py::test_bf16_forward_matches_f32 (0.15; msnet
  0.35, its argmax pooling flips on near-ties).
- targets, adapters, pool/unpool, the tone shuffle, the positional table:
  equal; the losses within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.models import adapters as JA
from viterbi_spl_tpu.models import targets as JTG
from viterbi_spl_tpu.models.ftanet import FTANet as JFTANet
from viterbi_spl_tpu.models.jdc import JDC as JJDC
from viterbi_spl_tpu.models.msnet import MSNet as JMSNet
from viterbi_spl_tpu.models.msnet import max_pool_freq4_argmax as j_pool
from viterbi_spl_tpu.models.msnet import unpool_freq4 as j_unpool
from viterbi_spl_tpu.models.tonet import TONet as JTONet
from viterbi_spl_tpu.models.tonet import cfp_to_tcfp as j_tcfp
from viterbi_spl_tpu.models.tonet import sinusoid_table as j_table
from viterbi_spl_tpu_torch.models import adapters as TA
from viterbi_spl_tpu_torch.models import targets as TTG
from viterbi_spl_tpu_torch.models.convert import convert
from viterbi_spl_tpu_torch.models.ftanet import FTANet
from viterbi_spl_tpu_torch.models.jdc import JDC
from viterbi_spl_tpu_torch.models.msnet import MSNet, max_pool_freq4_argmax, unpool_freq4
from viterbi_spl_tpu_torch.models.tonet import TONet, cfp_to_tcfp, sinusoid_table

EVAL_RTOL = 1e-4
BS_F64_RTOL = 2e-3


def flax_variables(model, x, seed):
    """flax's param and batch-stat trees for `model` on input `x`, filled with
    seeded values (see the module docstring)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, shape)
        elif name == "var":
            v = 1 + np.abs(rng.normal(0, 0.1, shape))
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, v) for k, v in shapes.items()}


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def jax_forward(model, variables, x, batch_stats=False, f64=False):
    """The JAX model's forward, jitted (eager flax compiles every op on its
    first call, some twenty seconds for TONet here); batch statistics with
    its Dropout layers intercepted to the identity, in float64 if asked."""
    def apply(v, x):
        if batch_stats or f64:
            return model.apply(v, x, train=True, mutable=["batch_stats"])[0]
        return model.apply(v, x, train=False)

    if f64:
        with jax.enable_x64(True), nn.intercept_methods(no_dropout):
            v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
            out = jax.jit(apply)(v, jnp.asarray(x, jnp.float64))
            return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), out)
    with nn.intercept_methods(no_dropout):
        out = jax.jit(apply)(variables, jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, out)


def port_model(cls, family, variables, **kw):
    state_dict, model_kw = convert(family, variables["params"], variables.get("batch_stats", {}))
    model = cls(**model_kw, **kw).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def port_forward(model, x, batch_stats=False):
    with torch.no_grad():
        out = model(torch.from_numpy(x), batch_stats=batch_stats)
    if isinstance(out, dict):
        return {k: None if v is None else v.numpy() for k, v in out.items()}
    return out.numpy()


def assert_close(got, want, rtol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            if want[k] is None:
                assert got[k] is None, (what, k)
            else:
                assert_close(got[k], want[k], rtol, f"{what} {k}")
        return
    assert got.shape == want.shape and got.dtype == np.float32, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} against {rtol} x {scale}"


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9)


# (name, JAX constructor, port class, family, input shape, batch-stat
# reference (f64 or f32), bf16 bound)
MODELS = [
    ("msnet", lambda dt: JMSNet(dtype=dt), MSNet, "msnet", (2, 8, 320, 3), "f32", 0.35),
    ("ftanet", lambda dt: JFTANet(dtype=dt), FTANet, "ftanet", (3, 8, 320, 3), "f64", 0.15),
    ("jdc", lambda dt: JJDC(dtype=dt), JDC, "jdc", (2, 31, 513), "f32", 0.15),
    ("tonet", lambda dt: JTONet(attn_dim=32, dtype=dt), TONet, "tonet", (3, 3, 360, 8), "f64",
     0.15),
]


@pytest.mark.parametrize("name,make,cls,family,shape,bs_ref,bf16_tol", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_matches_jax(rng, name, make, cls, family, shape, bs_ref, bf16_tol):
    """Each model in eval mode and with batch statistics, float32, against
    the JAX model on the same weights (tolerances in the module
    docstring)."""
    x = rng.normal(size=shape).astype(np.float32)
    jm = make(jnp.float32)
    variables = flax_variables(jm, x, seed=1)
    model = port_model(cls, family, variables)
    assert_close(port_forward(model, x), jax_forward(jm, variables, x), EVAL_RTOL, f"{name} eval")
    got = port_forward(model, x, batch_stats=True)
    if bs_ref == "f64":
        want = jax_forward(make(jnp.float64), variables, x, f64=True)
        assert_close(got, jax.tree_util.tree_map(lambda a: a.astype(np.float32), want),
                     BS_F64_RTOL, f"{name} batch stats vs float64")
    else:
        assert_close(got, jax_forward(jm, variables, x, batch_stats=True), EVAL_RTOL,
                     f"{name} batch stats")
    # the running averages are untouched by a batch-statistics forward
    state = port_model(cls, family, variables).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("name,make,cls,family,shape,bs_ref,bf16_tol", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_bf16_matches_jax_bf16(rng, name, make, cls, family, shape, bs_ref, bf16_tol):
    """--bf16: convs, denses and LSTMs in bfloat16, logits float32, within
    the per-model bound of tests/test_precision.py of the JAX package's
    bfloat16 logits."""
    x = rng.normal(size=shape).astype(np.float32)
    variables = flax_variables(make(jnp.float32), x, seed=2)
    model = port_model(cls, family, variables, dtype=torch.bfloat16)
    got = port_forward(model, x)
    want = jax_forward(make(jnp.bfloat16), variables, x)
    for k in (want if isinstance(want, dict) else [None]):
        g, w = (got[k], want[k]) if k is not None else (got, want)
        if w is None:
            continue
        assert g.dtype == np.float32 and np.all(np.isfinite(g))
        assert rel_l2(w, g) < bf16_tol, (name, k, rel_l2(w, g))


@pytest.mark.parametrize("mode", ["spat", "spl", "tcfp", "single"])
def test_tonet_modes_match_jax(rng, mode):
    """TONet's other ablation modes on the ftanet backbone, eval mode; the
    mode and attn_dim are read back from the params by convert."""
    x = rng.normal(size=(1, 3, 360, 4)).astype(np.float32)
    jm = JTONet(attn_dim=32, mode=mode)
    variables = flax_variables(jm, x, seed=3)
    state_dict, kw = convert("tonet", variables["params"], variables["batch_stats"])
    assert kw["mode"] == mode and kw.get("attn_dim", 32) == 32
    model = TONet(**kw).eval()
    model.load_state_dict(state_dict, strict=True)
    assert_close(port_forward(model, x), jax_forward(jm, variables, x), EVAL_RTOL, mode)


def test_tonet_refuses_unported_backbones():
    """Every backbone of the JAX package is ported (models/provenance.py);
    a name outside TONET_BACKBONES is refused."""
    for backbone in ("ftanet", "mcdnn", "msnet", "mldrnet"):
        assert TONet(attn_dim=32, mode="single", backbone=backbone).backbone == backbone
    with pytest.raises(ValueError, match="unknown TONet backbone"):
        TONet(backbone="resnet")


@pytest.mark.parametrize("backbone,mode", [("mcdnn", "all"), ("msnet", "single"),
                                           ("mldrnet", "single")])
def test_tonet_provenance_backbones_match_jax(rng, backbone, mode):
    """TONet on models/provenance.py's backbones (MCDNN, the 360-bin MSnet,
    MLDRnet; MCDNN in the dual "all" mode, the others bare), eval mode and
    batch statistics, float32: the eval bound (no SF module normalizes
    chunk means here); convert reads the backbone back from the params. In
    training mode the port's BatchNorm averages move as flax's (train=True)
    do."""
    x = rng.normal(size=(2, 3, 360, 8)).astype(np.float32)
    jm = JTONet(attn_dim=32, mode=mode, backbone=backbone)
    variables = flax_variables(jm, x, seed=6)
    state_dict, kw = convert("tonet", variables["params"], variables.get("batch_stats", {}))
    assert kw["backbone"] == backbone and kw["mode"] == mode
    model = TONet(**kw).eval()
    model.load_state_dict(state_dict, strict=True)
    assert_close(port_forward(model, x), jax_forward(jm, variables, x), EVAL_RTOL, backbone)
    assert_close(port_forward(model, x, batch_stats=True),
                 jax_forward(jm, variables, x, batch_stats=True), EVAL_RTOL, f"{backbone} bs")
    with nn.intercept_methods(no_dropout):
        _, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        model.train()(torch.from_numpy(x))
    want, _ = convert("tonet", variables["params"],
                      jax.tree_util.tree_map(np.asarray, upd.get("batch_stats", {})))
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_shuffles_pools_and_tables_equal_jax(rng):
    cfp = rng.normal(size=(2, 3, 360, 5)).astype(np.float32)
    np.testing.assert_array_equal(cfp_to_tcfp(torch.from_numpy(cfp)).numpy(),
                                  np.asarray(j_tcfp(jnp.asarray(cfp))))
    np.testing.assert_array_equal(sinusoid_table(128, 64), j_table(128, 64))
    # msnet's pool takes the first maximum of each group of 4, on ties too
    x = rng.integers(0, 3, size=(2, 5, 16, 3)).astype(np.float32)  # NHWC [B, T, F, C]
    jp, ji = j_pool(jnp.asarray(x))
    tp, ti = max_pool_freq4_argmax(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(tp.permute(0, 2, 3, 1).numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.permute(0, 2, 3, 1).numpy(), np.asarray(ji))
    up = unpool_freq4(tp, ti, 15).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(up, np.asarray(j_unpool(jp, ji, 15)))


def test_targets_and_losses_match_jax(rng):
    np.testing.assert_array_equal(TTG._tonet_note_range(), JTG._tonet_note_range())
    np.testing.assert_array_equal(TTG._msnet_note_range(), JTG._msnet_note_range())
    np.testing.assert_array_equal(TTG.DCNET_NOTE_RANGE, JTG.DCNET_NOTE_RANGE)
    np.testing.assert_array_equal(TTG.JDC_NOTE_RANGE, JTG.JDC_NOTE_RANGE)
    notes = np.where(rng.random((2, 40)) < 0.3, 0.0, rng.uniform(20, 100, (2, 40))).astype(np.float32)
    notes[0, :4] = [0.0, 10.0, 23.5, 150.0]  # unvoiced, below and above the grids
    t_lb = TTG.tonet_labels(torch.from_numpy(notes))
    j_lb = JTG.tonet_labels(jnp.asarray(notes))
    for k in ("pitch", "chroma", "octave"):
        np.testing.assert_array_equal(t_lb[k].numpy(), np.asarray(j_lb[k]))
    T = torch.from_numpy
    # the losses on notes inside every grid (a note far outside a softmax
    # grid has no target mass, and both packages give NaN there)
    notes = np.where(notes > 0, np.clip(notes, 40.0, 80.0), 0.0).astype(np.float32)
    lg = {"pitch": rng.normal(size=(2, 361, 40)), "chroma": rng.normal(size=(2, 13, 40)),
          "octave": rng.normal(size=(2, 7, 40))}
    lg = {k: v.astype(np.float32) for k, v in lg.items()}
    cases = [
        (TTG.tonet_loss(T(notes), {k: T(v) for k, v in lg.items()}),
         JTG.tonet_loss(jnp.asarray(notes), {k: jnp.asarray(v) for k, v in lg.items()})),
        (TTG.dcnet_loss(T(notes), T(lg["pitch"][:, :320].transpose(0, 2, 1).copy())),
         JTG.dcnet_loss(jnp.asarray(notes), jnp.asarray(lg["pitch"][:, :320].transpose(0, 2, 1)))),
        (TTG.softmax_smoothed_loss(T(notes), T(lg["pitch"][:, :321].transpose(0, 2, 1).copy())),
         JTG.softmax_smoothed_loss(jnp.asarray(notes),
                                   jnp.asarray(lg["pitch"][:, :321].transpose(0, 2, 1)))),
    ]
    p722 = rng.normal(size=(2, 40, 722)).astype(np.float32)
    v = rng.normal(size=(2, 40)).astype(np.float32)
    cases.append((TTG.jdc_loss(T(notes), T(p722), T(v)),
                  JTG.jdc_loss(jnp.asarray(notes), jnp.asarray(p722), jnp.asarray(v))))
    for got, want in cases:
        assert np.isfinite(float(want))
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_adapters_match_jax(rng):
    c = rng.normal(size=(3, 128, 321)).astype(np.float32)
    np.testing.assert_array_equal(TA.ftanet_pitch_logits(c, 300), JA.ftanet_pitch_logits(c, 300))
    np.testing.assert_array_equal(TA.msnet_pitch_logits(c), JA.msnet_pitch_logits(c))
    np.testing.assert_array_equal(TA.dcnet_pitch_logits(c[:1, :, :320]),
                                  JA.dcnet_pitch_logits(c[:1, :, :320]))
    p = rng.normal(size=(3, 361, 128)).astype(np.float32)
    np.testing.assert_array_equal(TA.tonet_pitch_logits(p, 300), JA.tonet_pitch_logits(p, 300))
    pj, vj = rng.normal(size=(4, 31, 722)).astype(np.float32), rng.normal(size=(4, 31)).astype(np.float32)
    for a, b in zip(TA.jdc_outputs(pj, vj, 100), JA.jdc_outputs(pj, vj, 100)):
        np.testing.assert_array_equal(a, b)
    e = rng.normal(size=(721, 20)).astype(np.float32)
    np.testing.assert_array_equal(TA.imm_pitch_logits(e), JA.imm_pitch_logits(e))
    bins = np.array([0, 5, 720, 900])
    grid = TTG.JDC_NOTE_RANGE
    np.testing.assert_array_equal(TA.jdc_est_notes(bins, grid), JA.jdc_est_notes(bins, grid))
