"""Inclusive associative scans with the time axis over a `time` mesh axis
(counterpart of `aux_ssm_tpu/parallel/time_scan.py`): the two-level block
scan of the scan kernels, lifted to the mesh.

  1. each shard scans its own T/S block, through the port's scan kernels
     for the filtering and sampling scans (`ops/cuda/filter_scan.py`: the
     filter scan and the affine scan, their plain versions on the CPU);
  2. the S block totals are all-gathered, and their inclusive scan runs
     once a process (S is small) by the plain operator;
  3. each shard combines its prefix, the total of the blocks before it,
     with every element of its block, by the plain operator of
     `ops/filtering.py` or `ops/sampling.py`.

Operator convention (as `ops/filtering` and `ops/sampling`): op(e1, e2)
applies e2 after e1; a forward scan's e1 is the earlier block, a reverse
scan's the later one, so the combine is op(prefix, local) either way.

The functions take whole tensors (every process the same) and return whole
tensors; each process scans its own blocks only.
"""
import torch

from . import collectives as col
from ..ops.cuda._build import has_instance

TIME = "time"


def _sequential_scan(operator, elems, reverse=False):
    """Inclusive scan of a tuple of tensors along axis 0, one step at a time
    (the default local scan of an arbitrary operator)."""
    n = elems[0].shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, out = None, [None] * n
    for t in order:
        cur = tuple(z[t:t + 1] for z in elems)
        acc = cur if acc is None else tuple(operator(acc, cur))
        out[t] = acc
    return tuple(torch.cat(z) for z in zip(*out))


def sharded_associative_scan(mesh, operator, elems, reverse=False, axis=TIME, local_scan=None):
    """Inclusive scan of `elems` (a tuple of tensors, leading axis T) under
    `operator`, with T over `mesh[axis]`. `local_scan(block)` scans one
    shard's block (default: one step at a time). Equals the one-device
    scan up to floating-point reassociation.

    T need not divide by the shard count: the tail (the head, reversed) is
    padded with copies of the edge element, which an inclusive scan's T
    results never read, and which keep every lane finite."""
    elems = tuple(elems)
    S = mesh.shape[axis]
    T = elems[0].shape[0]
    pad = (-T) % S
    if pad:
        def grow(z):
            reps = (z[:1] if reverse else z[-1:]).expand((pad,) + z.shape[1:])
            return torch.cat([reps, z] if reverse else [z, reps])
        out = sharded_associative_scan(mesh, operator, tuple(grow(z) for z in elems), reverse,
                                       axis, local_scan)
        return tuple(z[pad:] if reverse else z[:T] for z in out)

    local_scan = local_scan or (lambda block: _sequential_scan(operator, block, reverse))
    leaves = [col.split(mesh, z, 0, axis) for z in elems]
    blocks = [tuple(leaf[i] for leaf in leaves) for i in range(len(leaves[0]))]
    scanned = [tuple(local_scan(b)) for b in blocks]
    def total(z):  # a block's fully combined element
        return z[:1] if reverse else z[-1:]
    totals = [col.gather(mesh, [total(s[j]) for s in scanned], 0, axis)
              for j in range(len(elems))]
    incl = _sequential_scan(operator, tuple(totals), reverse)
    out = []
    for s, block in zip(col.axis_index(mesh, axis), scanned):
        has = s < S - 1 if reverse else s > 0
        if not has:
            out.append(block)
            continue
        at = s + 1 if reverse else s - 1
        prefix = tuple(z[at:at + 1].to(b.device).expand(b.shape) for z, b in zip(incl, block))
        out.append(tuple(operator(prefix, block)))
    return tuple(col.gather(mesh, [o[j] for o in out], 0, axis) for j in range(len(elems)))


def sharded_filtering_scan(mesh, elems, axis=TIME):
    """The filtering scan of elements (A, b, C, eta, J) (`ops/filtering`)
    with time over `mesh[axis]`: each shard's block through the filter scan
    kernel (its plain version on the CPU, or past the kernels' widths)."""
    from ..ops.cuda.filter_scan import filter_scan, filter_scan_plain
    from ..ops.filtering import filtering_operator
    scan = (filter_scan if has_instance(elems[1].shape[-1], dtype=elems[1].dtype)
            else filter_scan_plain)
    return sharded_associative_scan(mesh, filtering_operator, elems, axis=axis,
                                    local_scan=scan)


def sharded_sampling_scan(mesh, gains_incs, axis=TIME):
    """The reverse scan of backward-sampling affine maps (G, e)
    (`ops/sampling`) with time over `mesh[axis]`: each shard's block
    through the affine scan kernel, reversed."""
    from ..ops.cuda.filter_scan import affine_scan, affine_scan_plain
    from ..ops.sampling import sampling_operator
    scan = (affine_scan if has_instance(gains_incs[1].shape[-1], dtype=gains_incs[1].dtype)
            else affine_scan_plain)
    return sharded_associative_scan(mesh, sampling_operator, gains_incs, reverse=True,
                                    axis=axis, local_scan=lambda b: scan(*b, reverse=True))
