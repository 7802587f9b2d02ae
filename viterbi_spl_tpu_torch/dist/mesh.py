"""The device mesh (counterpart of viterbi_spl_tpu/dist/mesh.py).

The JAX package's mesh is a jax `Mesh` that one process drives: a
shard_map runs every device's share from a single controller. The port's
mesh is the same thing without a runtime behind it, a [data, seq] grid of
`torch.device`s that one process walks over: the sharded decodes move each
share to its device with `.to(device)`, launch there, and gather the
results. A halo exchange between time blocks is a cyclic shift of the
per-block tensors.

A device may appear more than once. `["cpu"] * 8` is the CPU tests'
counterpart of the 8 virtual XLA devices in tests/conftest.py, and
`[cuda:0] * 8` runs eight blocks on one card: blocks that share a device
are launched together (dist/sharded_viterbi.py). `torch.distributed` is not
used: NCCL cannot run two ranks on one GPU, so ranks could not put several
blocks on one card.
"""

from __future__ import annotations

import dataclasses

import torch

AXES = ("data", "seq")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [data, seq] grid of devices."""

    devices: tuple  # tuple (data) of tuples (seq) of torch.device

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "seq": len(self.devices[0])}

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, at index 0 of the other axis (a decode
        split over one axis is replicated over the other, as under
        shard_map)."""
        if axis == "data":
            return [row[0] for row in self.devices]
        if axis == "seq":
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXES}")


def make_mesh(data: int | None = None, seq: int = 1, devices=None) -> Mesh:
    """Mesh over (data, seq). devices defaults to every CUDA device (none
    is an error: a mesh of the CPU is asked for by name, e.g. ["cpu"] * 8);
    data defaults to n_devices // seq."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError(
                "no CUDA device for the mesh; pass devices=[...] (e.g. ['cpu'] * n) "
                "to build one on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % seq != 0:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data < 1 or seq < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} seq={seq}")
    if data * seq > n:
        raise ValueError(f"mesh {data}x{seq} needs more than {n} devices")
    return Mesh(tuple(tuple(devices[i * seq:(i + 1) * seq]) for i in range(data)))
