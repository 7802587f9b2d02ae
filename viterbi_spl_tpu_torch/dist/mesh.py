"""The device mesh (counterpart of viterbi_spl_tpu/dist/mesh.py).

The JAX package's mesh is a jax `Mesh` that one process drives: a
shard_map runs every device's share from a single controller. The port's
mesh is the same thing without a runtime behind it, a grid of
`torch.device`s that one process walks over: [data, seq] for the decodes,
[data, model] for training (dist/tp.py). The sharded decodes move each
share to its device with `.to(device)`, launch there, and gather the
results. A halo exchange between time blocks is a cyclic shift of the
per-block tensors.

A device may appear more than once. `["cpu"] * 8` is the CPU tests'
counterpart of the 8 virtual XLA devices in tests/conftest.py, and
`[cuda:0] * 8` runs eight blocks on one card: blocks that share a device
are launched together (dist/sharded_viterbi.py). Within one process,
`torch.distributed` is not used: NCCL cannot run two ranks on one GPU, so
ranks could not put several blocks on one card.

A mesh may also span processes joined by utils.initialize_distributed
(gloo): `process_devices(local)` lists every process's devices, and a
mesh built from that list records the rank owning each entry. A process
then works only on its own entries (`is_local`), and what crosses
processes goes through torch.distributed on host tensors.
"""

from __future__ import annotations

import dataclasses

import torch

AXES = ("data", "seq", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A two-axis grid of devices: [data, seq] or [data, model]."""

    devices: tuple  # tuple (axes[0]) of tuples (axes[1]) of torch.device
    axes: tuple = ("data", "seq")
    # the same grid of the ranks owning each device; None: this process's
    ranks: tuple | None = None

    @property
    def shape(self) -> dict:
        return {self.axes[0]: len(self.devices), self.axes[1]: len(self.devices[0])}

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, at index 0 of the other axis (a decode
        split over one axis is replicated over the other, as under
        shard_map)."""
        if axis == self.axes[0]:
            return [row[0] for row in self.devices]
        if axis == self.axes[1]:
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axes}")

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len({r for row in self.ranks for r in row}) > 1

    def is_local(self, i: int, j: int = 0) -> bool:
        """Whether entry (i, j) belongs to this process."""
        if self.ranks is None:
            return True
        from ..utils import process_index

        return self.ranks[i][j] == process_index()

    def local_rows(self) -> list[int]:
        """The rows along axes[0] whose devices all belong to this process."""
        return [i for i in range(len(self.devices))
                if all(self.is_local(i, j) for j in range(len(self.devices[i])))]


def process_devices(local_devices) -> list:
    """Every process's devices as (rank, torch.device) pairs, in rank order:
    each process passes its own (e.g. ["cpu", "cpu"], or its CUDA devices).
    Collective: every process of the runtime calls it."""
    import torch.distributed as dist

    from ..utils import process_count

    mine = [str(torch.device(d)) for d in local_devices]
    everyone = [None] * process_count()
    if process_count() > 1:
        dist.all_gather_object(everyone, mine)
    else:
        everyone = [mine]
    return [(rank, torch.device(d)) for rank, devs in enumerate(everyone) for d in devs]


def _grid(devices, rows: int, cols: int, axes: tuple) -> Mesh:
    """A rows x cols Mesh from the first rows * cols entries of devices
    (torch devices, or (rank, device) pairs from process_devices)."""
    entries = list(devices)[: rows * cols]
    spanning = all(isinstance(e, tuple) for e in entries)
    devs = [torch.device(e[1] if spanning else e) for e in entries]
    grid = tuple(tuple(devs[i * cols:(i + 1) * cols]) for i in range(rows))
    ranks = (tuple(tuple(e[0] for e in entries[i * cols:(i + 1) * cols]) for i in range(rows))
             if spanning else None)
    return Mesh(grid, axes, ranks)


def _default_devices():
    from ..utils import process_count

    n_cuda = torch.cuda.device_count()
    if n_cuda == 0:
        raise RuntimeError(
            "no CUDA device for the mesh; pass devices=[...] (e.g. ['cpu'] * n) "
            "to build one on the CPU"
        )
    local = [torch.device("cuda", i) for i in range(n_cuda)]
    return process_devices(local) if process_count() > 1 else local


def make_mesh(data: int | None = None, seq: int = 1, devices=None) -> Mesh:
    """Mesh over (data, seq). devices defaults to every CUDA device (of
    every process, once utils.initialize_distributed has joined several;
    none is an error: a mesh of the CPU is asked for by name, e.g.
    ["cpu"] * 8); data defaults to n_devices // seq."""
    devices = _default_devices() if devices is None else list(devices)
    n = len(devices)
    if data is None:
        if n % seq != 0:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data < 1 or seq < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} seq={seq}")
    if data * seq > n:
        raise ValueError(f"mesh {data}x{seq} needs more than {n} devices")
    return _grid(devices, data, seq, ("data", "seq"))


def parse_mesh_spec(text: str, axes=("data",)) -> dict:
    """--mesh's value, comma-separated axis=N (e.g. "data=4,model=2") ->
    {axis: N} with every axis of `axes` (1 where not given); a malformed
    value or an axis outside `axes` exits with a usage message."""
    try:
        kv = dict(part.split("=", 1) for part in text.split(","))
        sizes = {a: int(kv.pop(a, 1)) for a in axes}
    except ValueError:
        raise SystemExit(
            f"--mesh: expected comma-separated axis=N (e.g. data=8), got {text!r}"
        )
    if kv:
        allowed = " and ".join(f"{a}=N" for a in axes)
        raise SystemExit(f"--mesh: only {allowed} {'is' if len(axes) == 1 else 'are'} "
                         f"supported, got {kv}")
    if any(n < 1 for n in sizes.values()):
        raise SystemExit(f"--mesh: axis sizes must be >= 1, got {text!r}")
    return sizes


def mesh_device_list(n: int, device, what: str) -> list:
    """n devices for a --mesh: n blocks of the CPU when the device is the
    CPU, else the first n CUDA devices; fewer CUDA devices exits, naming
    the count (`what` starts the message)."""
    if torch.device(device or "cuda").type == "cpu":
        return [torch.device("cpu")] * n
    n_cuda = torch.cuda.device_count()
    if n_cuda < n:
        raise SystemExit(f"{what}: only {n_cuda} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def local_tracks(mesh: Mesh, n: int) -> slice:
    """The tracks of an n-track batch whose states a track-sharded decode
    (dist.sharded_viterbi.decode_tracks_sharded) returns in this process:
    its data devices' contiguous shares (all n within one process)."""
    bounds = [0]
    for i in range(len(mesh.devices)):
        bounds.append(bounds[-1] + n // len(mesh.devices) + (i < n % len(mesh.devices)))
    mine = [i for i in range(len(mesh.devices)) if mesh.is_local(i)]
    if not mine:
        return slice(0, 0)
    return slice(bounds[mine[0]], bounds[mine[-1] + 1])
