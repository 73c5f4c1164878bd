"""Parallel-in-time cSMC over a device mesh (counterpart of
`aux_ssm_tpu/kernels/pit_sharded.py`): the particle-sharded kernel splits
each tree level's O(N^2) block-mass pass over a `particles` axis; the
time-sharded kernel splits the tree itself over a `time` axis.

Time-sharded decomposition (T = C Tc, chunk length Tc a power of two >= 2):

  1. local phase: chunk c runs the tree's levels inside its Tc steps
     (`pit.run_stitch_tree`) on its shard's device: its slice of each
     level's row uniforms (it holds the level's nodes c n_c .. (c + 1) n_c
     - 1, n_c its nodes a level), the level's own seed, and a pair offset of
     c n_c, so its draws are the one-device tree's draws of those nodes. It
     returns its selections and its first- and last-step particle sets;
  2. upper phase: the C chunks' boundary sets are all-gathered and a
     super-tree over them runs once a process with the global tree's upper
     levels' noise and the root's (`level_sizes(C)` is the global upper
     levels' sizes for any C, a power of two or not);
  3. resolution: the root resolves to one index a chunk, and each chunk
     resolves its own genealogy and takes its trajectory slice.

The boundary values are gathered, not recomputed, and every level sees the
global tree's noise, so the drawn indices are the one-device kernel's bit
for bit. The proposals and their weights (one step's N values each,
independent over time) run once a process. Both kernels take the
one-device kernel's `noise` (`pit.get_kernel`); one chain (x (T, d)).
"""
import math

import torch

from . import pit
from .csmc_base import CSMCState
from ..parallel import collectives as col
from ..parallel.mesh import PARTICLES
from ..parallel.time_scan import TIME


def _kernel(step, N):
    def kernel(state, generator=None, noise=None):
        x = state.x
        if x.dim() != 2:
            raise ValueError(f"a sharded PIT kernel runs one chain: x (T, d), got "
                             f"{tuple(x.shape)}")
        if noise is None:
            noise = (torch.randn(x.shape[0], N, x.shape[1], generator=generator,
                                 dtype=x.dtype, device=x.device),) + pit.draw_noise(
                                     x.shape[0], N, x, generator)
        x_new, picked = step(x, noise)
        return CSMCState(x=x_new, updated=picked != 0)

    def init(x_star):
        return CSMCState(x=x_star, updated=torch.zeros(x_star.shape[0], dtype=torch.bool,
                                                       device=x_star.device))
    return init, kernel


def get_particle_sharded_kernel(Mt, G0, Gt, N, mesh, Qt=None, axis=PARTICLES, draws="joint",
                                stitch="auto", block_max="row"):
    """The PIT-cSMC kernel with each level's block masses column-sharded over
    `mesh[axis]` (`pit.sharded_block_masses`): each shard scores every row
    against its N/S columns, the masses are all-gathered, and the draws run
    once a process with the one-device counter stream. Bit-equal to
    `pit.get_kernel(..., stitch="blocked", block_max="block")` under either
    `draws`. Needs a pair-factorising Gt and N/S a multiple of 128 (S the
    axis size). A one-shard mesh is `pit.get_kernel(..., stitch, draws,
    block_max)`. Returns (init, kernel), `kernel(state, generator=None,
    noise=None)`."""
    if not getattr(Gt, "supports_pairwise_factors", False):
        raise ValueError("particle-sharded PIT needs a pair-factorisable Gt "
                         "(supports_pairwise_factors)")
    S = mesh.shape[axis]
    if N % (128 * S):
        raise ValueError(f"particle-sharded PIT needs N/S a multiple of 128 (N={N}, S={S})")
    if S == 1:
        return pit.get_kernel(Mt, G0, Gt, N, Qt, stitch=stitch, draws=draws,
                              block_max=block_max)
    pit.check_routes("blocked", draws)
    return _kernel(lambda x, noise: pit._pit_csmc(x, Mt, G0, Gt, N, Qt, noise, "blocked", draws,
                                                  "block", score_mesh=mesh, score_axis=axis), N)


def check_shapes(T, C):
    """Raise ValueError unless C divides T into chunks of a power of two >= 2
    steps."""
    if T % C or T // C < 2:
        raise ValueError(f"time-sharded PIT needs C | T and T/C >= 2 (T={T}, C={C})")
    Tc = T // C
    if Tc & (Tc - 1):
        raise ValueError(f"time-sharded PIT needs the chunk length T/C to be a power of two "
                         f"(got {Tc}); C itself may be any shard count")


def get_sharded_kernel(Mt, G0, Gt, N, mesh, Qt=None, axis=TIME, stitch="auto", draws="joint"):
    """The PIT-cSMC kernel with the time axis over `mesh[axis]` (the module
    docstring): the contract of `pit.get_kernel`, whose draws it repeats bit
    for bit. T = C Tc with Tc a power of two >= 2 (C = the axis size, any
    count); a one-shard mesh is `pit.get_kernel`."""
    C = mesh.shape[axis]
    if C == 1:
        return pit.get_kernel(Mt, G0, Gt, N, Qt, stitch=stitch, draws=draws)
    pit.check_routes(stitch, draws)
    init, kernel = _kernel(lambda x, noise: _sharded_pit(x, Mt, G0, Gt, N, Qt, noise, mesh,
                                                         axis, stitch, draws), N)

    def checked_init(x_star):
        check_shapes(x_star.shape[0], C)
        return init(x_star)
    return checked_init, kernel


def _sharded_pit(x_star, Mt, G0, Gt, N, Qt, noise, mesh, axis, stitch, draws):
    eps, levels, root = noise
    T = x_star.shape[0]
    C = mesh.shape[axis]
    check_shapes(T, C)
    Tc = T // C
    Kl = int(math.log2(Tc))
    n_c = [Tc // (2 << k) for k in range(Kl)]               # a chunk's nodes a level
    route = dict(stitch=stitch, draws=draws)

    xs, log_wts = pit.proposals(x_star, Mt, G0, Qt, eps)
    params = pit._shifted_params(Gt.params)

    # ---- local phase: each chunk's interior levels, on its shard ----
    xs_c = col.split(mesh, xs, 0, axis)
    lw_c = col.split(mesh, log_wts, 0, axis)
    params_c = col.split_tree(mesh, params, 0, axis)
    local = []
    for i, c in enumerate(col.axis_index(mesh, axis)):
        dev = xs_c[i].device
        noise_c = [(u[c * n:(c + 1) * n].to(dev), seed.to(dev))
                   for (u, seed), n in zip(levels[:Kl], n_c)]
        sels, _, bounds = pit.run_stitch_tree(
            xs_c[i], xs_c[i], lw_c[i], noise_c, params_c[i], Gt, N, include_root=False,
            pair_offset=[c * n for n in n_c], return_bounds=True, **route)
        local.append((sels, bounds))

    # ---- upper phase: the super-tree over the C chunk boundaries ----
    firsts = col.gather(mesh, [b[0][None] for _, b in local], 0, axis)
    lasts = col.gather(mesh, [b[1][None] for _, b in local], 0, axis)
    home = firsts.device
    upper = [(u.to(home), s.to(home)) for u, s in levels[Kl:]]
    sels_up, root_pair = pit.run_stitch_tree(
        lasts, firsts, None, upper + [tuple(z.to(home) for z in root)],
        pit.tree_map(lambda z: z[::Tc].to(home), params), Gt, N, include_root=True, **route)
    j_chunk = pit.resolve_genealogy(sels_up, pit._root_init(root_pair, C, N), C, N)

    # ---- resolution: each chunk's genealogy and trajectory slice ----
    x_parts, idx_parts = [], []
    for i, c in enumerate(col.axis_index(mesh, axis)):
        sels, _ = local[i]
        j = j_chunk[c].to(xs_c[i].device)
        idx = pit.resolve_genealogy(sels, j.expand(Tc), Tc, N)
        x_parts.append(pit._take_steps(xs_c[i], idx))
        idx_parts.append(idx)
    return col.gather(mesh, x_parts, 0, axis), col.gather(mesh, idx_parts, 0, axis)
