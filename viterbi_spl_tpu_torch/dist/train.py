"""Training over a device mesh: the step behind `train --mesh
data=N[,model=M]` (the JAX package trains on a globally sharded batch and
lets GSPMD insert the collectives, apps/common.py:640-698, dist/tp.py).

A mesh's data rows each hold a replica of the model on the row's first
device (the caller's model is replica 0). A step splits the global batch
into contiguous shares, one a row, and runs each share's forward on its
replica, one thread a share (`ShareGroup.run`), so that the forwards meet
at every BatchNorm: there the shares' statistic sums are reduced before
any share normalizes (models/layers.py::data_share), and Dropout keeps its
rows of the global batch's mask. The loss is the global mean; one backward
runs through every share's graph, the reductions included, and
`MeshOptimizer.step` sums each gradient over the replicas, applies one
Adam update and hands the new values to every replica, which therefore
stay identical.

With model=M (tensor parallelism), parameters, Adam's moments and the
BatchNorm averages are stored split over the model axis by the tp rule
(dist/tp.py): each step gathers the full tensors onto every replica,
reduces each gradient to the devices of its shards, and runs Adam there on
each shard. Adam is elementwise, so this is the replicated update for the
same gradient: the same loss, the same updated parameters, another layout.

A mesh may span processes (utils.initialize_distributed; whole data rows
to a process): each process runs its own rows, and the BatchNorm sums, the
gradients and the reported loss are summed across processes by
torch.distributed on host tensors (gloo). Within one process nothing goes
through torch.distributed, so a device may repeat: `[cuda:0] * 4` or
`["cpu"] * 4` is a four-share mesh.
"""

from __future__ import annotations

import copy
import threading

import torch

from ..models.layers import data_share
from ..utils import on_device
from .mesh import Mesh
from .tp import join_shards, split_tensor, tp_param_specs, tp_shard_tree

# seconds a share waits at a BatchNorm for the others before the step fails
SHARE_TIMEOUT_S = 600.0


def world_all_reduce(tensors) -> None:
    """Sum each tensor in place over every process (gloo, through one host
    buffer); nothing within one process."""
    import torch.distributed as dist

    from ..utils import process_count

    tensors = [t for t in tensors if t is not None]
    if process_count() == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to("cpu", torch.float64) for t in tensors])
    dist.all_reduce(flat)
    with torch.no_grad():
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.reshape(t.shape))


class _WorldSum(torch.autograd.Function):
    """Sum over every process of `group`, on host copies; its backward sums
    the gradients the same way (each process's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        host = t.detach().to("cpu", copy=True)
        dist.all_reduce(host, group=group)
        return host.to(t.device)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        host = grad.detach().to("cpu", copy=True)
        dist.all_reduce(host, group=ctx.group)
        return host.to(grad.device), None


class ShareGroup:
    """The data shares of a mesh step in this process, one thread each,
    and their reductions (models/layers.py's BatchNorm calls
    `all_reduce`). devices: the local shares' devices; size: the global
    number of shares; first: the global index of local share 0;
    cross_process: reduce across processes too. Each process's share 0
    sums the local shares' tensors in share order on its device (and, across
    processes, on a gloo group of its own for each reduction of a step, so
    that backward passes whose reductions run in another order on another
    process cannot cross), then every share takes the sum onto its device.
    A share that fails breaks the barrier, so that the others fail too
    instead of waiting."""

    def __init__(self, devices, size: int, first: int = 0, cross_process: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.size = size
        self.first = first
        self.cross_process = cross_process
        self._barrier = threading.Barrier(len(self.devices), timeout=SHARE_TIMEOUT_S)
        self._slots = [None] * len(self.devices)
        self._result = None
        self._calls = 0
        self._groups = []

    def global_index(self, index: int) -> int:
        return self.first + index

    def _wait(self):
        if len(self.devices) > 1:
            self._barrier.wait()

    def _group(self, k: int):
        import torch.distributed as dist

        while len(self._groups) <= k:
            self._groups.append(dist.new_group(backend="gloo"))
        return self._groups[k]

    def all_reduce(self, index: int, t: torch.Tensor) -> torch.Tensor:
        """The sum of every share's `t` (differentiable), on t's device."""
        if len(self.devices) == 1 and not self.cross_process:
            return t
        self._slots[index] = t
        self._wait()
        if index == 0:
            total = self._slots[0]
            for other in self._slots[1:]:
                total = total + other.to(total.device)
            if self.cross_process:
                total = _WorldSum.apply(total, self._group(self._calls))
            self._calls += 1
            self._result = total
        self._wait()
        return self._result.to(t.device)

    def run(self, fn, items) -> list:
        """[fn(i, items[i]) for every local share i], each in its own thread
        (inline for one share) inside data_share(self, i)."""
        self._calls = 0
        n = len(self.devices)
        if n == 1:
            with data_share(self, 0), on_device(self.devices[0]):
                return [fn(0, items[0])]
        results, errors = [None] * n, []

        def work(i):
            try:
                with data_share(self, i), on_device(self.devices[i]):
                    results[i] = fn(i, items[i])
            except BaseException as e:  # handed to the caller below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self._barrier.reset()
            primary = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
            raise (primary or errors)[0]
        return results


class MeshOptimizer:
    """The optimizer of a model trained over a [data] or [data, model] mesh
    (see the module docstring): the replicas, the share group, and the
    store Adam updates. It stands where the single-device optimizer stands
    in a TrainState: `zero_grad`, `step`, `update_count`, and
    `state_dict`/`load_state_dict` in the layout of an optimizer over the
    model's own parameters (so that a mesh checkpoint restores into a
    single-device run, and a single-device one into a mesh), plus
    `scatter`, which hands replica 0's tensors (restored into it by the
    Trainer) to the store and to every replica.

    model: replica 0, moved to the first local row's first device.
    make_optimizer(params) -> the optimizer over the tensors Adam updates
    (replica 0's parameters, or with model=M their shards)."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, make_optimizer):
        rows = mesh.local_rows()
        if not rows:
            raise ValueError("no row of the mesh belongs to this process")
        if any(mesh.is_local(i, j) for i in range(len(mesh.devices)) if i not in rows
               for j in range(len(mesh.devices[i]))):
            raise ValueError("a row of the mesh spans processes: give each process whole rows")
        self.mesh = mesh
        self.rows = rows
        self.devices = [mesh.devices[r][0] for r in rows]
        self.n_model = mesh.shape.get("model", 1)
        self.cross_process = mesh.spans_processes
        model.to(self.devices[0])
        self.replicas = [model] + [copy.deepcopy(model).to(d) for d in self.devices[1:]]
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.group = ShareGroup(self.devices, len(mesh.devices), rows[0], self.cross_process)
        if self.n_model > 1:
            self.specs = tp_param_specs(model, self.n_model)
            self.store = tp_shard_tree(model.state_dict(), mesh, self.specs, row=rows[0])
            for name in self.names:
                self.store[name].shards = [torch.nn.Parameter(s) for s in self.store[name].shards]
            self.optimizer = make_optimizer(
                [s for name in self.names for s in self.store[name].shards])
        else:
            self.specs, self.store = {}, None
            params = dict(model.named_parameters())
            self.optimizer = make_optimizer([params[n] for n in self.names])

    # -- the forward ------------------------------------------------------
    def local_shares(self, *tensors) -> list:
        """This process's shares of a global batch (each tensor's dim 0 cut
        into one contiguous share a data row): one tuple a local row."""
        n_rows, B = len(self.mesh.devices), tensors[0].shape[0]
        if B % n_rows:
            raise ValueError(f"a batch of {B} does not split into {n_rows} equal shares")
        b = B // n_rows
        return [tuple(t[r * b:(r + 1) * b] for t in tensors) for r in self.rows]

    def run(self, fn, items) -> list:
        """fn(i, replica i, items[i]) for every local share, in step (see
        ShareGroup.run); every replica in training mode."""
        for rep in self.replicas:
            rep.train()
        return self.group.run(lambda i, item: fn(i, self.replicas[i], item), items)

    def share_mean(self, values) -> torch.Tensor:
        """This process's part of the global mean of per-share values (the
        whole mean within one process), on the first local device."""
        dev = self.devices[0]
        total = values[0].to(dev)
        for v in values[1:]:
            total = total + v.to(dev)
        return total / len(self.mesh.devices)

    def world_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the processes of the mesh (t itself within one)."""
        if not self.cross_process:
            return t
        t = t.detach().clone()
        world_all_reduce([t])
        return t

    # -- the update --------------------------------------------------------
    def zero_grad(self, set_to_none: bool = True) -> None:
        for rep in self.replicas:
            rep.zero_grad(set_to_none=set_to_none)
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def reduce_grads(self) -> None:
        """Each gradient summed over the replicas (share order) and the
        processes, onto what Adam updates: replica 0's parameter, or each
        shard on its device."""
        dev = self.devices[0]
        named = [dict(rep.named_parameters()) for rep in self.replicas]
        grads = []
        for name in self.names:
            g = None
            for rep in named:
                gi = rep[name].grad
                if gi is not None:
                    g = gi.to(dev) if g is None else g + gi.to(dev)
            grads.append(g)
        world_all_reduce(grads)
        for name, g in zip(self.names, grads):
            if self.store is None:
                named[0][name].grad = g
                continue
            shards = self.store[name].shards
            pieces = [None] * len(shards) if g is None else \
                split_tensor(g, self.store[name].spec, self.n_model)
            for s, p in zip(shards, pieces):
                s.grad = None if p is None else p.to(s.device).contiguous()

    def apply_update(self, weight_decay=None) -> None:
        """weight_decay: (param name, wd), the dcnet rule grad += wd * w on
        one kernel (harness/train.py::add_weight_decay_grad), then Adam."""
        if weight_decay is not None:
            name, wd = weight_decay
            targets = (self.store[name].shards if self.store is not None
                       else [dict(self.replicas[0].named_parameters())[name]])
            for t in targets:
                t.grad = t.grad + wd * t.detach()
        self.optimizer.step()

    @torch.no_grad()
    def gather(self, buffers: bool = False) -> None:
        """Every replica takes the updated tensors: with model=M the store's
        (the BatchNorm averages first taken from replica 0, which every
        replica moved alike), else replica 0's parameters (and, with
        buffers, its averages)."""
        if self.store is None:
            src = self.replicas[0].state_dict(keep_vars=True)
            keep = set(self.names) if not buffers else set(src)
            for rep in self.replicas[1:]:
                for name, t in rep.state_dict(keep_vars=True).items():
                    if name in keep:
                        t.copy_(src[name])
            return
        src = self.replicas[0].state_dict(keep_vars=True)
        trained = set(self.names)
        for name, sh in self.store.items():
            if name not in trained:
                for s, p in zip(sh.shards, split_tensor(src[name], sh.spec, self.n_model)):
                    s.copy_(p)
        for rep, dev in zip(self.replicas, self.devices):
            live = rep.state_dict(keep_vars=True)
            for name, sh in self.store.items():
                live[name].copy_(join_shards(sh.shards, sh.spec, dev))

    def step(self, weight_decay=None) -> None:
        self.reduce_grads()
        self.apply_update(weight_decay)
        self.gather()

    def update_count(self) -> int:
        return self.optimizer.update_count()

    # -- checkpoints -----------------------------------------------------
    @torch.no_grad()
    def scatter(self) -> None:
        """Replica 0's tensors (a restored checkpoint's) into the store and
        every other replica."""
        if self.store is not None:
            src = self.replicas[0].state_dict(keep_vars=True)
            for name, sh in self.store.items():
                for s, p in zip(sh.shards, split_tensor(src[name], sh.spec, self.n_model)):
                    s.copy_(p)
        self.gather(buffers=True)

    def state_dict(self) -> dict:
        """The optimizer's state in the layout of one over replica 0's
        parameters: each moment gathered from its shards."""
        inner = self.optimizer.state_dict()
        if self.store is None:
            return inner
        state, pos = {}, 0
        for k, name in enumerate(self.names):
            sh = self.store[name]
            parts = [inner["state"].get(pos + j) for j in range(len(sh.shards))]
            pos += len(sh.shards)
            if not parts[0]:
                continue
            state[k] = {key: (join_shards([p[key] for p in parts], sh.spec, parts[0][key].device)
                              if torch.is_tensor(v) and v.ndim else v)
                        for key, v in parts[0].items()}
        group = dict(inner["param_groups"][0], params=list(range(len(self.names))))
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, sd: dict) -> None:
        """A state_dict in the single-device layout, split onto the shards."""
        if self.store is None:
            self.optimizer.load_state_dict(sd)
            return
        state, pos = {}, 0
        for k, name in enumerate(self.names):
            sh = self.store[name]
            st = sd["state"].get(k)
            for j in range(len(sh.shards)):
                if st:
                    # every shard its own copy: Adam counts each one's step
                    state[pos + j] = {
                        key: (split_tensor(v, sh.spec, self.n_model)[j].clone()
                              if torch.is_tensor(v) and v.ndim
                              else v.clone() if torch.is_tensor(v) else v)
                        for key, v in st.items()}
            pos += len(sh.shards)
        group = dict(sd["param_groups"][0], params=list(range(pos)))
        self.optimizer.load_state_dict({"state": state, "param_groups": [group]})
