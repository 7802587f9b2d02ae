"""The port's DCNet (viterbi_spl_tpu_torch/models/dcnet.py) and its weight
conversion (models/convert.py::dcnet_state_dict) against the JAX package's
flax DCNet on the CPU, at its published widths (500 NSGT bins in, 16 local
channels, the 128-channel global conv over 320 bins, dense 64).

The flax weights are the model's own param tree (jax.eval_shape of its
init) filled with seeded values (tests/test_torch_models.py::flax_variables),
BatchNorm running statistics included, so that eval mode normalizes by
non-trivial statistics. Tolerance: eval mode, max |diff| <= 1e-4 *
max|JAX| (conv and matmul sum orders, a few ulps a layer: the same bound
as tests/test_torch_models.py's other families).
"""

import numpy as np
import pytest
import torch

from test_torch_models import EVAL_RTOL, flax_variables, jax_forward, port_model
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu.apps import dcnet as j_dcnet_app
from viterbi_spl_tpu.models.dcnet import DCNet as JDCNet
from viterbi_spl_tpu_torch.apps import dcnet as t_dcnet_app
from viterbi_spl_tpu_torch.models import DCNet
from viterbi_spl_tpu_torch.models.convert import convert


@pytest.mark.parametrize("B,T", [(2, 24), (1, 7)])
def test_dcnet_eval_matches_flax(rng, B, T):
    """Eval mode on [B, T, 500] features: within EVAL_RTOL of flax, with
    the weights convert() carries across (strict load: every tensor of
    the port's module has its flax counterpart)."""
    x = rng.random((B, T, 500)).astype(np.float32)
    model = JDCNet()
    variables = flax_variables(model, x, seed=5)
    want = jax_forward(model, variables, x)
    got = port_model(DCNet, "dcnet", variables)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (B, T, 320) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_RTOL * np.abs(want).max())


def test_dcnet_conversion_and_app_config():
    """The converted tree carries every flax leaf once, in PyTorch's layouts
    (OIHW kernels, [out, in] denses); the app's inference fields are the
    JAX app's."""
    x = np.zeros((1, 8, 500), np.float32)
    variables = flax_variables(JDCNet(), x, seed=1)
    sd, kwargs = convert("dcnet", variables["params"], variables["batch_stats"])
    assert kwargs == {}
    n_flax = sum(np.asarray(v).size for tree in variables.values()
                 for v in _leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_flax
    assert sd["global_conv.weight"].shape == (128, 16, 1, 97)
    assert sd["local_conv.1.weight"].shape == (16, 16, 3, 5)
    assert sd["fusion_dense.weight"].shape == (64, 128)
    assert set(sd) == set(DCNet().state_dict())
    j, t = j_dcnet_app.config(), t_dcnet_app.config()
    assert (t.snippet_len, t.batch_size, t.fixed_chunks) == (j.snippet_len, j.batch_size, False)
    assert t.family.name == "dcnet" and t.family.n_bins == 320


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
