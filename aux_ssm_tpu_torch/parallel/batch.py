"""The batch axis of a batched LGSSM over a `batch` mesh axis (counterpart
of `aux_ssm_tpu/parallel/batch.py`).

The batched layouts (`ops/lgssm.py`) run B independent filters as one (T,
B, ...) program: every filtering and sampling op is elementwise over B, so
each shard can run the filters and the draw of its own B/S columns (the
scalar scans of `ops/cuda/scalar_scan.py` in the batched scalar layout)
with no communication.

The JAX package leaves the rest of the auxiliary-Kalman step to GSPMD. The
port cannot: a model's gradient factory and target density may couple the
components (the spatial model's `log_potential` reads the whole grid), so
they are not separable over B. `batch_sharded_kernel` therefore runs the
factories and the target on the whole (T, B) trajectory, once a process,
runs each shard's proposal filters, draw and proposal density on its
columns, all-gathers the drawn trajectory and the per-column densities,
and takes the accept decision once. Given the same noise (drawn whole, then
sliced per shard) a step equals the unsharded one up to the order of its
reductions, with the same accept.

Layout: m0 (B, dx) and P0 (B, dx, dx) lead with B; Fs, Qs, bs, Hs, Rs, cs,
ys and x are (T[-1], B, ...), B on axis 1.
"""
from . import collectives as col
from .mesh import BATCH
from ..ops.lgssm import LGSSM


def shard_time_major(mesh, tree, axis=BATCH):
    """This process's shards of every leaf's axis 1 (the batch axis of (T, B,
    ...) tensors): a list, one tree a local shard."""
    return col.split_tree(mesh, tree, 1, axis)


def shard_batched_lgssm(mesh, lgssm: LGSSM, axis=BATCH):
    """This process's shards of a batched LGSSM: m0 and P0 split on axis 0,
    the per-step parameters on axis 1."""
    heads = [col.split(mesh, z, 0, axis) for z in (lgssm.m0, lgssm.P0)]
    steps = shard_time_major(mesh, tuple(lgssm[2:]), axis)
    return [LGSSM(m0, P0, *rest) for m0, P0, rest in zip(*heads, steps)]


def constrain_batch(tree, mesh, axis=BATCH):
    """Keep (T, B, ...) leaves sharded over `mesh[axis]`: a tree becomes this
    process's shards (`shard_time_major`), and a list of shards moves each
    onto its shard's device. The port has no compiler to hint: the
    constraint is the placement itself."""
    if not isinstance(tree, list):
        return shard_time_major(mesh, tree, axis)
    from .chains import _map_state
    return [_map_state(lambda z, d=d: z.to(d), part)
            for part, d in zip(tree, mesh.local_devices(axis))]


def sharded_proposal(mesh, ys, lgssm, eps, x_eval, parallel, axis=BATCH):
    """Each shard's proposal filters, draw (unless `x_eval` is given) and
    proposal density on its B/S columns. Returns (the log proposal density
    of each column (B,), the whole trajectory (T, B, dx)), both gathered."""
    from ..ops.filtering import filtering
    from ..ops.lgssm import posterior_logpdf
    from ..ops.sampling import sampling
    models = shard_batched_lgssm(mesh, lgssm, axis)
    y_parts = col.split(mesh, ys, 1, axis)
    given = col.split(mesh, x_eval, 1, axis) if x_eval is not None else [None] * len(models)
    noise = col.split(mesh, eps, 1, axis) if x_eval is None else [None] * len(models)
    dens, trajs = [], []
    for y, model, x, e in zip(y_parts, models, given, noise):
        ms, Ps, ell = filtering(y, model, parallel, keep_batch=True)
        if x is None:
            x = sampling(e, ms, Ps, model, parallel)
        dens.append(posterior_logpdf(y, x, ell, model, keep_batch=True))
        trajs.append(x)
    return col.gather(mesh, dens, 0, axis), col.gather(mesh, trajs, 1, axis)


def batch_sharded_kernel(kernel, mesh, axis=BATCH):
    """The auxiliary-Kalman `kernel` (of `kernels.kalman.get_kernel` with
    `chains`, or a model builder's wrapping of one) with its proposal run
    per shard over `mesh[axis]` (the module docstring). Same state, delta
    and noise as `kernel`."""
    if not hasattr(kernel, "batch_sharded"):
        raise ValueError("batch_sharded_kernel needs an auxiliary-Kalman kernel in a batched "
                         "layout (kernels.kalman.get_kernel(..., chains=True) or a model "
                         "builder's kalman kernel)")
    return kernel.batch_sharded(mesh, axis)
