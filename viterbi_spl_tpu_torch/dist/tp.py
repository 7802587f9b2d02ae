"""Tensor-parallel parameter sharding over a named "model" axis
(counterpart of viterbi_spl_tpu/dist/tp.py).

The JAX package shards params, their Adam moments and the BatchNorm
averages over a `model` mesh axis by a shape rule and lets GSPMD insert
the collectives. The port keeps the rule and stores the same leaves split
the same way: shard j of a leaf lies on the mesh's model device j
(dist/train.py's MeshOptimizer gathers full tensors for each step's
forward, reduces each gradient to its shards' devices, and runs Adam on
the shards there; Adam is elementwise, so the update equals the
replicated one for the same gradient).

The rule reads flax's layouts in the JAX package: there the trailing
dimension is the output channel (HWIO conv kernels, [in, out] dense
kernels, per-channel vectors). The port stores OIHW / OIW kernels and
[out, in] dense weights (models/convert.py), so it reads the same rule off
dimension 0. nn.LSTM stacks flax's four per-gate kernels (and biases) into
one tensor of 4 H rows: the rule is applied to one gate's H rows, and a
shard holds its slice of every gate. The leaves the port shards are then
exactly those the JAX rule shards on the flax tree, through convert's name
map (tests/test_torch_mesh_train.py holds that for every NN family).
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import Mesh, _default_devices, _grid


def make_tp_mesh(data: int, model: int, devices=None) -> Mesh:
    """Mesh over (data, model): batches shard over "data", channel dims
    over "model". devices defaults to every CUDA device (of every process,
    once several are joined); entries may repeat (["cpu"] * 4)."""
    devices = _default_devices() if devices is None else list(devices)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    if data * model > len(devices):
        raise ValueError(f"mesh {data}x{model} needs more than {len(devices)} devices")
    return _grid(devices, data, model, ("data", "model"))


@dataclasses.dataclass(frozen=True)
class Split:
    """Dimension 0 split over the model axis, in `groups` equal blocks each
    split alike (nn.LSTM's four gates)."""

    groups: int = 1


def tp_spec(shape, model_axis_size: int, groups: int = 1) -> Split | None:
    """The tp shape rule on the port's layouts: split the output-channel
    dimension (dim 0; one gate's rows of a stacked LSTM tensor) where it is
    at least twice the axis size and divides evenly by it; None
    (replicated) otherwise, and for scalars."""
    if len(shape) == 0 or shape[0] % groups:
        return None
    rows = shape[0] // groups
    if rows >= 2 * model_axis_size and rows % model_axis_size == 0:
        return Split(groups)
    return None


def _gate_groups(model: torch.nn.Module) -> dict:
    """name -> 4 for every tensor of an nn.LSTM (weight_ih/hh, bias_ih/hh:
    four gate blocks stacked on dim 0)."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, torch.nn.LSTM):
            for name, _ in mod.named_parameters(recurse=False):
                out[f"{prefix}.{name}" if prefix else name] = 4
    return out


def tp_param_specs(model: torch.nn.Module, model_axis_size: int) -> dict:
    """name -> Split or None for every tensor of the model's state_dict (its
    params and BatchNorm averages) under the tp rule. An Adam moment takes
    its param's spec."""
    groups = _gate_groups(model)
    return {name: tp_spec(tuple(t.shape), model_axis_size, groups.get(name, 1))
            for name, t in model.state_dict(keep_vars=True).items()}


def split_tensor(t: torch.Tensor, spec: Split | None, n: int) -> list:
    """The n shards of t under spec (views; [t] when replicated)."""
    if spec is None:
        return [t]
    g = spec.groups
    blocks = t.reshape(g, t.shape[0] // g, *t.shape[1:])
    return [p.reshape(-1, *t.shape[1:]) for p in torch.chunk(blocks, n, dim=1)]


def join_shards(shards, spec: Split | None, device) -> torch.Tensor:
    """The full tensor from its shards, on `device` (split_tensor's inverse)."""
    if spec is None:
        return shards[0].to(device)
    g = spec.groups
    parts = [s.to(device).reshape(g, s.shape[0] // g, *s.shape[1:]) for s in shards]
    full = torch.cat(parts, dim=1)
    return full.reshape(-1, *full.shape[2:])


@dataclasses.dataclass
class Sharded:
    """A tensor stored split over the model axis: shards[j] on model device
    j (one shard on model device 0 when replicated)."""

    shards: list
    spec: Split | None

    def full(self, device) -> torch.Tensor:
        return join_shards(self.shards, self.spec, device)


def tp_shard_tree(tree: dict, mesh: Mesh, specs: dict | None = None, row: int = 0) -> dict:
    """Every tensor of a name -> tensor dict split under the tp rule over the
    model devices of the mesh's row `row` (copies; a replicated tensor on
    model device 0) -> name -> Sharded. specs: name -> Split or None (from
    tp_param_specs, which knows an LSTM's gates); by default the rule on
    each tensor's shape. Works for params, BatchNorm averages and Adam's
    moments alike."""
    size = mesh.shape["model"]
    devices = list(mesh.devices[row])
    out = {}
    for name, t in tree.items():
        spec = specs[name] if specs is not None else tp_spec(tuple(t.shape), size)
        pieces = split_tensor(t.detach(), spec, size)
        out[name] = Sharded([p.to(d, copy=True).contiguous() for p, d in zip(pieces, devices)],
                            spec)
    return out
