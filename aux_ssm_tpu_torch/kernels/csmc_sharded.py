"""Conditional SMC with the particle axis over a `particles` mesh axis
(counterpart of `aux_ssm_tpu/kernels/csmc_sharded.py`).

The forward sweep keeps each shard's N/S particles on its device: the
proposals and the weights' model terms run per shard. The two global steps
of each time step run once a process on the all-gathered log weights (N
values): their normalisation and the resampling draw, so the indices are
the one-device generic loop's bit for bit; each shard then takes its
particles' ancestors from the all-gathered particles
(`parallel/resampling.py`'s rule).

The backward passes stay sharded: the (T, N, d) particles never gather on
one shard. Whiteley backward sampling all-gathers one (N,) weight row a
step (the draw is the one-device loop's) and receives the chosen particle
from its owner by a masked `psum` (`_fetch_row`); ancestor scanning chases
the genealogy one index a step the same way.

At S > 1 the sweep is the generic step loop of `kernels/csmc.py`, whatever
the model offers: the factor, lane and block-lane sweeps are one-device
kernels (the JAX package turns its fused paths off under a sharding
constraint too). A one-shard mesh is `csmc.get_kernel`, fused sweeps
included. Noise: the one-device kernel's (`csmc.draw_noise`), each shard
taking its slice of the particle axis; one chain (x (T, d)).
"""
import torch

from . import csmc
from .csmc_base import CSMCState
from ..ops import resampling as resampling_mod
from ..ops.logspace import normalize
from ..ops.take import take_rows
from ..parallel import collectives as col
from ..parallel.mesh import PARTICLES


def get_sharded_kernel(M0, G0, Mt, Gt, N, mesh, backward=False, Pt=None,
                       resampling="multinomial", axis=PARTICLES):
    """`csmc.get_kernel` with the N particles over `mesh[axis]`; S, the
    axis size, must divide N. Returns (init, kernel) with `kernel(state,
    generator=None, noise=None)`."""
    S = mesh.shape[axis]
    if N % S:
        raise ValueError(f"N={N} not divisible by the {axis!r} axis size {S}")
    if S == 1:
        return csmc.get_kernel(M0, G0, Mt, Gt, N, backward=backward, Pt=Pt,
                               resampling=resampling)
    if backward and Pt is None:
        Pt = Mt
    if backward and not hasattr(Pt, "logpdf"):
        raise ValueError("backward=True requires `Pt` to implement logpdf.")
    resample = resampling_mod.get(resampling) if isinstance(resampling, str) else resampling
    if resample not in (resampling_mod.multinomial, resampling_mod.systematic):
        raise ValueError("resampling must be 'multinomial' or 'systematic'")

    def kernel(state, generator=None, noise=None):
        x = state.x
        if x.dim() != 2:
            raise ValueError(f"a particle-sharded kernel runs one chain: x (T, d), got "
                             f"{tuple(x.shape)}")
        if noise is None:
            noise = csmc.draw_noise(x, N, resample, generator)
        eps_m0, res_u, eps_prop, _, us = noise
        w_T, xs, log_ws, ancestors = sharded_forward_pass(mesh, x, M0, G0, Mt, Gt, N, resample,
                                                         (eps_m0, res_u, eps_prop), axis)
        if backward:
            x_new, picked = sharded_backward_sampling_pass(mesh, Pt, w_T, xs, log_ws, us, axis)
        else:
            x_new, picked = sharded_backward_scanning_pass(mesh, w_T, xs, ancestors,
                                                           us[-1], axis)
        return CSMCState(x=x_new, updated=picked != 0)

    def init(x_star):
        return CSMCState(x=x_star, updated=torch.zeros(x_star.shape[:-1], dtype=torch.bool,
                                                       device=x_star.device))

    return init, kernel


def _pin_shard0(mesh, parts, value, axis):
    """Global particle 0 (row 0 of shard 0) set to `value`, in place."""
    for s, p in zip(col.axis_index(mesh, axis), parts):
        if s == 0:
            p[0] = value.to(p.device)
    return parts


def _weights(mesh, log_w_parts, axis):
    """The normalised weights (N,) from each shard's log weights, once a
    process (the generic loop's `normalize` on the same N values)."""
    return normalize(col.gather(mesh, log_w_parts, 0, axis), -1)


def sharded_forward_pass(mesh, x_star, M0, G0, Mt, Gt, N, resample, noise, axis=PARTICLES):
    """The generic forward sweep with the particles over `mesh[axis]`;
    noise (eps_m0 (N, d), res_u, eps_prop (T-1, N, d)). Returns (w_T (N,),
    xs, log_ws, ancestors): w_T whole; xs (T, N/S, d), log_ws (T, N/S) and
    ancestors (T-1, N/S) as lists of this process's shards (shard s's rows
    are global particles s N/S .. (s + 1) N/S - 1)."""
    eps_m0, res_u, eps_prop = noise
    T = x_star.shape[0]
    step_resample = (resampling_mod.multinomial_from_uniforms
                     if resample is resampling_mod.multinomial
                     else resampling_mod.systematic_from_uniforms)
    e0 = col.split(mesh, eps_m0, 0, axis)
    ep = col.split(mesh, eps_prop, 1, axis)
    x_prev = _pin_shard0(mesh, [M0.sample_from_noise(e) for e in e0], x_star[0], axis)
    log_w = [G0(xp) for xp in x_prev]
    w = _weights(mesh, log_w, axis)
    n = N // mesh.shape[axis]
    xs, log_ws, ancestors = [[z] for z in x_prev], [[z] for z in log_w], [[] for _ in x_prev]
    for t in range(T - 1):
        anc = step_resample(res_u[t].to(w.device), w)
        x_all = col.all_gather(mesh, x_prev, 0, axis)
        x_t = []
        for i, s in enumerate(col.axis_index(mesh, axis)):
            mine = anc[s * n:(s + 1) * n].to(x_all[i].device)
            x_prev[i] = take_rows(x_all[i], mine)
            x_t.append(Mt.sample_from_noise(ep[i][t], x_prev[i], csmc._at(Mt.params, t)))
            ancestors[i].append(mine)
        _pin_shard0(mesh, x_t, x_star[t + 1], axis)
        log_w = [Gt(xt, xp, csmc._at(Gt.params, t)) for xt, xp in zip(x_t, x_prev)]
        w = _weights(mesh, log_w, axis)
        for i, (xt, lw) in enumerate(zip(x_t, log_w)):
            xs[i].append(xt)
            log_ws[i].append(lw)
        x_prev = x_t
    anc_out = [torch.stack(a) if a else torch.empty(0, n, dtype=torch.int64, device=p[0].device)
               for a, p in zip(ancestors, xs)]
    return w, [torch.stack(z) for z in xs], [torch.stack(z) for z in log_ws], anc_out


def _fetch_row(mesh, parts, pos, axis=PARTICLES):
    """Row `pos` (global, a 0-d tensor) of a value whose rows are sharded as
    `parts`: its owner contributes it, every shard receives it by `psum`."""
    n = parts[0].shape[0]
    rows = []
    for s, p in zip(col.axis_index(mesh, axis), parts):
        at = pos.to(p.device)
        row = p.index_select(0, (at % n).reshape(1))[0]
        rows.append(torch.where(at // n == s, row, torch.zeros_like(row)))
    return col.psum(mesh, rows, axis)[0]


def sharded_backward_sampling_pass(mesh, Pt, w_T, xs, log_ws, us, axis=PARTICLES):
    """Whiteley backward sampling with xs (T, N/S, d) and log_ws (T, N/S)
    sharded as lists: a step's (N,) smoothing-weight row is all-gathered
    for the draw (the one-device loop's), the chosen particle arrives by
    `_fetch_row`. Returns (x (T, d), picked (T,))."""
    T = xs[0].shape[0]
    b = resampling_mod.categorical_from_uniform(us[-1].to(w_T.device), w_T)
    picked, rows = [b], [_fetch_row(mesh, [z[-1] for z in xs], b, axis)]
    for t in range(T - 2, -1, -1):
        lw = [Pt.logpdf(rows[-1].to(x.device), x[t], csmc._at(Pt.params, t)) + lw_[t]
              for x, lw_ in zip(xs, log_ws)]
        b = resampling_mod.categorical_from_uniform(us[t].to(w_T.device),
                                                    _weights(mesh, lw, axis))
        picked.append(b)
        rows.append(_fetch_row(mesh, [z[t] for z in xs], b, axis))
    return torch.stack(rows[::-1]), torch.stack(picked[::-1])


def sharded_backward_scanning_pass(mesh, w_T, xs, ancestors, u, axis=PARTICLES):
    """The genealogy of a draw at the last step (`jax.random.choice`'s
    inverse CDF at (1 - u) * total) traced back with xs (T, N/S, d) and
    ancestors (T-1, N/S) sharded as lists: one index and one row a step by
    `_fetch_row`. Integer arithmetic: the picks are the one-device pass's.
    Returns (x (T, d), picked (T,))."""
    T = xs[0].shape[0]
    b = resampling_mod.choice_from_uniform(u.to(w_T.device), w_T)[0]
    picked, rows = [b], [_fetch_row(mesh, [z[-1] for z in xs], b, axis)]
    for t in range(T - 2, -1, -1):
        b = _fetch_row(mesh, [a[t] for a in ancestors], b, axis)
        picked.append(b)
        rows.append(_fetch_row(mesh, [z[t] for z in xs], b, axis))
    return torch.stack(rows[::-1]), torch.stack(picked[::-1])
