"""The collectives of the port's sharded functions: the counterparts of
`shard_map`'s `all_gather`, `psum`, `pmax`, `ppermute` and `axis_index`
along one mesh axis.

A sharded value is the list of this process's shards of it along the axis
(`Mesh.local_shards`), each tensor on its shard's device; `split` makes one
from a whole tensor and `gather` puts one back together. Inside one process
the collectives are `torch.cat`, sums, maxima and copies, in shard order.
Across processes (after `distributed.initialize`) each process's list joins
the others' through `torch.distributed`: NCCL for CUDA tensors, gloo for
CPU ones, by the tensors' device. A body over such lists runs the shards
one after another in shard order, so every sharded function is
deterministic and runs no threads.

Shards on one device share what a collective returns there (`all_gather`'s
result is one tensor on that device, not a copy a shard): treat it as read
only.
"""
import torch
import torch.distributed as dist

from . import distributed


def axis_size(mesh, axis):
    return mesh.shape[axis]


def axis_index(mesh, axis):
    """The index along `axis` of each of this process's shards."""
    return mesh.local_shards(axis)


def split(mesh, x, dim=0, axis=None):
    """This process's shards of `x`, cut along `dim` into mesh.shape[axis]
    equal parts, each on its shard's device. A size that the shard count
    does not divide raises ValueError."""
    S = mesh.shape[axis]
    if x.shape[dim] % S:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not split into {S} shards "
                         f"of mesh axis {axis!r}")
    n = x.shape[dim] // S
    devices = mesh.axis_devices(axis)
    return [x.narrow(dim, s * n, n).to(devices[s]) for s in mesh.local_shards(axis)]


def split_tree(mesh, tree, dim=0, axis=None):
    """`split` on every tensor of `tree` (a dataclass, tuple, list or dict of
    them): a list, one tree a local shard."""
    from .chains import _map_state
    parts = {}

    def cut(z):
        parts[id(z)] = split(mesh, z, dim, axis)
        return z
    _map_state(cut, tree)
    return [_map_state(lambda z, i=i: parts[id(z)][i], tree)
            for i in range(len(mesh.local_shards(axis)))]


def _cross(mesh, axis):
    """Whether `axis` spans more than this process."""
    if not distributed.is_initialized():
        return False
    ranks = set(mesh._line(mesh.ranks, axis))
    if len(ranks) > 1 and len(ranks) != distributed.process_count():
        raise ValueError(f"mesh axis {axis!r} spans {len(ranks)} of "
                         f"{distributed.process_count()} processes: a collective needs all")
    return len(ranks) > 1


def _whole(mesh, parts, dim, axis):
    """The concatenation of every shard along `dim`, on this process's first
    shard device."""
    dev = parts[0].device
    local = torch.cat([p.to(dev) for p in parts], dim) if len(parts) > 1 else parts[0]
    if not _cross(mesh, axis):
        return local
    moved = local.movedim(dim, 0).contiguous()
    every = [torch.empty_like(moved) for _ in range(distributed.process_count())]
    dist.all_gather(every, moved)
    return torch.cat(every, 0).movedim(0, dim)


def gather(mesh, parts, dim=0, axis=None):
    """The whole value of a sharded one, on this process's first shard
    device (every process gets it)."""
    return _whole(mesh, parts, dim, axis)


def all_gather(mesh, parts, dim=0, axis=None):
    """`jax.lax.all_gather(..., tiled=True)`: the whole value along `dim` on
    every local shard's device."""
    return _on_shards(mesh, axis, _whole(mesh, parts, dim, axis))


def _on_shards(mesh, axis, value):
    return [value.to(d) for d in mesh.local_devices(axis)]


def psum(mesh, parts, axis=None):
    """The sum over every shard, shard order within a process, on every
    local shard's device."""
    dev = parts[0].device
    total = parts[0].clone()
    for p in parts[1:]:
        total = total + p.to(dev)
    if _cross(mesh, axis):
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return _on_shards(mesh, axis, total)


def pmax(mesh, parts, axis=None):
    """The elementwise maximum over every shard."""
    dev = parts[0].device
    top = parts[0].clone()
    for p in parts[1:]:
        top = torch.maximum(top, p.to(dev))
    if _cross(mesh, axis):
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return _on_shards(mesh, axis, top)


def ppermute(mesh, parts, perm, axis=None):
    """`jax.lax.ppermute`: shard dst receives shard src's value for each
    (src, dst) of `perm`; a shard that receives nothing gets zeros. Across
    processes the pairs go by point-to-point sends."""
    local = mesh.local_shards(axis)
    devices = mesh.axis_devices(axis)
    ranks = mesh._line(mesh.ranks, axis)
    at = {s: i for i, s in enumerate(local)}
    out = [torch.zeros_like(p) for p in parts]
    ops = []
    for src, dst in perm:
        if src in at and dst in at:
            out[at[dst]] = parts[at[src]].to(devices[dst])
        elif src in at:
            ops.append(dist.P2POp(dist.isend, parts[at[src]].contiguous(), ranks[dst]))
        elif dst in at:
            ops.append(dist.P2POp(dist.irecv, out[at[dst]], ranks[src]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
