"""Device meshes (counterpart of `aux_ssm_tpu/parallel/mesh.py`).

A `Mesh` names its axes, gives each a size and holds an array of
`torch.device`s of that shape, one a shard. A device may repeat:
`make_mesh(devices=["cuda:0"] * 4, axis_names=(PARTICLES,))` is four shards
on one card, and `["cpu"] * 8` is what the CPU tests use (the counterpart of
the JAX package's 8 virtual CPU devices). `make_mesh()` with no devices
takes every card that `torch.cuda.device_count()` reports, and raises where
there is none: it never turns to the CPU.

After `parallel.distributed.initialize`, a mesh spans every process: the
devices a process passes (default: those it gave `initialize`) are its own
shards, and the processes' shards follow each other in rank order. Each
shard records the rank that holds it (`Mesh.ranks`); the collectives
(`parallel/collectives.py`) move data between a process's shards in place
and between processes through `torch.distributed`.

A function sharded over one axis uses the shards along that axis at index 0
of every other axis; the other axes see it replicated (JAX's `P(axis)`).
"""
from dataclasses import dataclass

import numpy as np
import torch

CHAINS, PARTICLES, BATCH = "chains", "particles", "batch"


@dataclass(frozen=True, eq=False)
class Mesh:
    """axis_names, and devices / ranks: object / int arrays of the axis
    sizes' shape (the device of each shard and the process holding it)."""
    axis_names: tuple
    devices: np.ndarray
    ranks: np.ndarray

    @property
    def shape(self):
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def _line(self, arr, axis):
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no axis {axis!r}")
        at = self.axis_names.index(axis)
        index = tuple(slice(None) if i == at else 0 for i in range(len(self.axis_names)))
        return list(arr[index])

    def axis_devices(self, axis):
        """The devices of the shards along `axis`, in shard order."""
        return self._line(self.devices, axis)

    def local_shards(self, axis):
        """The indices along `axis` of the shards this process holds: a
        contiguous run in rank order."""
        rank = _rank()
        return [s for s, r in enumerate(self._line(self.ranks, axis)) if r == rank]

    def local_devices(self, axis):
        devices = self.axis_devices(axis)
        return [devices[s] for s in self.local_shards(axis)]


def _rank():
    from . import distributed
    return distributed.process_index()


def make_mesh(axis_sizes=None, devices=None, axis_names=(CHAINS,)):
    """A Mesh over `devices` (torch.devices or their names; default every
    card) with `axis_names`. `axis_sizes` (as many as the names) may hold
    one -1, inferred; default all devices on the first axis. Sizes that do
    not multiply to the device count raise ValueError. After
    `distributed.initialize`, `devices` are this process's shards and the
    mesh spans every process's."""
    from . import distributed
    if devices is None:
        devices = distributed.default_local_devices()
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    every, ranks = distributed.gather_devices(devices)
    n = len(every)
    sizes = list(axis_sizes) if axis_sizes is not None else [n] + [1] * (len(axis_names) - 1)
    if len(sizes) != len(axis_names):
        raise ValueError(f"mesh sizes {sizes} do not match axes {tuple(axis_names)}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh sizes {sizes} do not multiply to {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = every
    return Mesh(tuple(axis_names), arr.reshape(sizes), np.asarray(ranks).reshape(sizes))


def local_mesh(axis_name=CHAINS):
    """1-D mesh over every card of this process (and, after `initialize`,
    of every process)."""
    return make_mesh(axis_names=(axis_name,))


@dataclass(frozen=True)
class Sharding:
    """Where a value goes on a mesh (counterpart of `NamedSharding`): `dim`
    split over `axis`, or every shard a whole copy when `dim` is None."""
    mesh: Mesh
    axis: str = CHAINS
    dim: int = None

    def place(self, tree):
        """This process's shards of `tree` (a tensor, or a dataclass, tuple,
        list or dict of them): a list, one tree a local shard, on its
        device."""
        from .chains import _map_state
        from .collectives import split_tree
        if self.dim is None:
            return [_map_state(lambda z, d=d: z.to(d), tree)
                    for d in self.mesh.local_devices(self.axis)]
        return split_tree(self.mesh, tree, self.dim, self.axis)


def chain_sharding(mesh, extra_dims=0):
    """The leading (chain) axis over the `chains` mesh axis, the rest whole
    (`extra_dims` kept for the JAX signature: the trailing axes need no
    spec here)."""
    del extra_dims
    return Sharding(mesh, CHAINS, 0)


def replicated(mesh, axis=CHAINS):
    """A whole copy on every shard of `axis`."""
    return Sharding(mesh, axis, None)
