"""Auxiliary Kalman MCMC kernel (counterpart of `aux_ssm_tpu/kernels/kalman.py`).

One step at state x:
  1. draw the auxiliary observation u = x + sqrt(delta / 2) * eps_aux;
  2. build a local LGSSM proposal around x from the user factories and draw a
     full trajectory x' from its exact Gaussian smoothing distribution
     (Kalman filter + backward sampling, parallel-in-time when requested);
  3. accept with the exact MH ratio, which includes the pi(x | u) auxiliary
     correction -sum[(x' - u)^2 - (x - u)^2] / delta.

Float32 matmuls must stay IEEE: reduced-precision matmuls (TF32 on the card)
collapse the acceptance rate; the package turns TF32 off at import.
"""
import dataclasses
from dataclasses import dataclass

import torch

from .base import SamplerState
from ..ops.filtering import filtering
from ..ops.lgssm import LGSSM, posterior_logpdf
from ..ops.sampling import sampling


@dataclass(frozen=True)
class KalmanSampler(SamplerState):
    """State of the auxiliary Kalman sampler: trajectory, whether the last
    proposal was accepted, and `log_target`, the cached log_likelihood_fn(x)
    that spares the reverse move one target evaluation (None when the state
    was built by hand; the kernel then recomputes it, with the same law)."""
    updated: torch.Tensor
    log_target: torch.Tensor = None


def get_kernel(dynamics_factory, observations_factory, log_likelihood_fn, parallel,
               chains=False, group=1, mesh=None, axis="batch"):
    """Build the auxiliary Kalman sampler.

    Parameters
    ----------
    dynamics_factory : Callable
        x -> (m0, P0, Fs, Qs, bs): prior part of the proposal LGSSM,
        linearised at the current trajectory.
    observations_factory : Callable
        (x, u, delta) -> (ys, Hs, Rs, cs): observation part of the proposal
        LGSSM, built from the auxiliary variable.
    log_likelihood_fn : Callable
        x -> unnormalised log-density of the FULL target at trajectory x
        (prior dynamics PLUS potential).
    parallel : bool
        Parallel-in-time filtering/sampling, or sequential loops.
    chains : bool
        C independent chains at once, time first: x (T, C, dx), delta (C,)
        or (C, T) (handed to the factories as given; `chain_delta` lines it
        up with x), the factories' proposal model in a batched layout of
        `ops/lgssm.py` (dx = dy = 1: the batched scalar layout; wider: the
        dense one, whose shared parameters may broadcast) and
        `log_likelihood_fn(x)` one target value a chain (C,). Each chain has
        its own proposal and target densities (nothing is summed over C) and
        its own accept; a step launches each kernel (the scalar scans, or
        the six d x d MH kernels) as often as one chain's step does, whatever
        C is. `chain_major` turns such a kernel into one over a leading
        chain axis, as `parallel/chains.py` runs it.
    group : int
        With `chains` in the batched scalar layout, the columns a chain
        holds: C chains of a model of `group` scalar components are C *
        group columns (chain c's are c * group .. (c + 1) * group - 1), x
        (T, C * group, 1); the delta (C,) or (C, T) and the accept (C,) are
        one a chain, lined up with its columns (`chain_delta(delta,
        group)`), the proposal densities and the MH correction are summed
        over each chain's columns, and `log_likelihood_fn` gives one value
        a chain (C,).
    mesh, axis : optional
        With `chains`, the batched layout's columns over `mesh[axis]`
        (`parallel/batch.py`): the factories and the target run on the
        whole trajectory, each shard's proposal filters, draw and density
        on its columns. `kernel.batch_sharded(mesh, axis)` builds this
        kernel so (`parallel.batch.batch_sharded_kernel`).

    Returns
    -------
    (init, kernel): `init(x) -> KalmanSampler` and
    `kernel(state, delta, generator=None, noise=None) -> KalmanSampler`.
    `noise`, if given, is `(eps_aux (T, dx), eps_smooth (T, dx), u_accept)`
    (with `chains`: (T, C, 1), (T, C, 1), (C,)) and replaces the draws from
    `generator`; the step accepts when `u_accept < alpha`, exactly as
    `jax.random.bernoulli`.
    """
    def per_step(z):
        return chain_delta(z, group) if chains else z

    def per_chain(z):
        """One value a chain from one a column."""
        return z.reshape(-1, group).sum(-1) if group > 1 else z

    if mesh is not None and not chains:
        raise ValueError("a batch mesh needs the batched layout of `chains`")

    def propose(delta, eps, u, x, x_eval=None, log_target=None):
        """Build the proposal LGSSM at x; sample from it unless `x_eval` is
        given (reverse-move density evaluation). Returns the proposal logpdf,
        the target log-density at `x_eval` (reusing `log_target` when the
        caller knows it), and the sampled or given trajectory."""
        m0, P0, Fs, Qs, bs = dynamics_factory(x)[:5]
        ys, Hs, Rs, cs = observations_factory(x, u, delta)[:4]
        lgssm = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
        if mesh is not None:
            from ..parallel.batch import sharded_proposal
            log_cols, x_eval = sharded_proposal(mesh, ys, lgssm, eps, x_eval, parallel, axis)
            log_prop = per_chain(log_cols)
        else:
            ms, Ps, ell = filtering(ys, lgssm, parallel, keep_batch=chains)
            if x_eval is None:
                x_eval = sampling(eps, ms, Ps, lgssm, parallel)
            log_prop = per_chain(posterior_logpdf(ys, x_eval, ell, lgssm, keep_batch=chains))
        if log_target is None:
            log_target = log_likelihood_fn(x_eval)
        return log_prop, log_target, x_eval

    def kernel(state, delta, generator=None, noise=None):
        x = state.x
        delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)
        if noise is None:
            kw = dict(generator=generator, dtype=x.dtype, device=x.device)
            noise = (torch.randn(x.shape, **kw), torch.randn(x.shape, **kw),
                     torch.rand((x.shape[1] // group,) if chains else (), **kw))
        eps_aux, eps_smooth, u_accept = noise
        sqrt_delta = torch.sqrt(per_step(delta))

        u = x + torch.sqrt(0.5 * per_step(delta)) * eps_aux
        log_prop_fwd, log_target_prop, x_prop = propose(delta, eps_smooth, u, x)
        log_prop_rev, log_target_rev, _ = propose(
            delta, None, u, x_prop, x, log_target=state.log_target)

        alpha = _acceptance_probability(log_prop_fwd, log_prop_rev, log_target_prop,
                                        log_target_rev, sqrt_delta, u, x, x_prop,
                                        per_chain if chains else None)
        accept = u_accept < alpha
        x_new = torch.where(per_step(accept), x_prop, x)
        lt_new = (None if state.log_target is None
                  else torch.where(accept, log_target_prop, log_target_rev))
        return KalmanSampler(x=x_new, updated=accept, log_target=lt_new)

    def init(x):
        return KalmanSampler(x=x, updated=torch.ones((x.shape[1] // group,) if chains else (),
                                                     dtype=torch.bool, device=x.device),
                             log_target=log_likelihood_fn(x))

    def batch_sharded(mesh, axis="batch"):
        return get_kernel(dynamics_factory, observations_factory, log_likelihood_fn, parallel,
                          chains, group, mesh, axis)[1]

    if chains:
        kernel.batch_sharded = batch_sharded
    return init, kernel


def chain_delta(delta, group=1):
    """A chain kernel's delta, (C,) or (C, T), lined up with its time-first
    trajectories (T, C, d): (C, 1) or (T, C, 1); with `group`, with those of
    C chains of `group` columns each (T, C * group, 1): each chain's delta
    on each of its columns."""
    if group > 1:
        delta = delta.repeat_interleave(group, 0)
    return delta[:, None] if delta.dim() == 1 else delta.transpose(0, 1)[..., None]


def chain_major(init, kernel, group=None):
    """(init, kernel) over a leading chain axis from those of
    `get_kernel(..., chains=True)`, which run time first: the state's x and
    the noise's trajectories are (C, T, d) outside, (T, C, d) inside; with
    `group` (the batched scalar layout's columns a chain, `get_kernel`'s),
    (C, T, group, 1) outside and (T, C * group, 1) inside. The rest
    (updated, log_target, u_accept (C,)) has the chain axis first already.
    The kernel is marked `chain_axis` (`experiments/cli.py` runs it as one
    batched step, not chain after chain)."""

    def inward(x):
        x = x.transpose(0, 1)
        return x if group is None else x.reshape(x.shape[0], -1, 1)

    def outward(x):
        if group is not None:
            x = x.reshape(x.shape[0], -1, group, 1)
        return x.transpose(0, 1).contiguous()

    def chained_init(x):
        state = init(inward(x))
        return dataclasses.replace(state, x=outward(state.x))

    def chained_kernel(state, delta, generator=None, noise=None):
        if noise is not None:
            noise = (inward(noise[0]), inward(noise[1]), noise[2])
        state = kernel(dataclasses.replace(state, x=inward(state.x)), delta,
                       generator=generator, noise=noise)
        return dataclasses.replace(state, x=outward(state.x))

    chained_kernel.chain_axis = True
    if hasattr(kernel, "batch_sharded"):
        chained_kernel.batch_sharded = lambda mesh, axis="batch": chain_major(
            init, kernel.batch_sharded(mesh, axis), group)[1]
    return chained_init, chained_kernel


def one_chain(init, kernel):
    """One chain's (init, kernel) from those over a leading chain axis
    (`chain_major`'s), run at C = 1: x, delta and the noise go in with a unit
    chain axis, and it comes off the state (x, and the scalar `updated` and
    `log_target`)."""

    def first(state):
        lt = state.log_target
        return dataclasses.replace(state, x=state.x[0], updated=state.updated[0],
                                   log_target=None if lt is None else lt[0])

    def unit(state):
        lt = state.log_target
        return dataclasses.replace(state, x=state.x[None], updated=state.updated.reshape(1),
                                   log_target=None if lt is None else lt.reshape(1))

    def one_init(x):
        return first(init(x[None]))

    def one_kernel(state, delta, generator=None, noise=None):
        delta = torch.as_tensor(delta, dtype=state.x.dtype, device=state.x.device)[None]
        if noise is not None:
            noise = tuple(torch.as_tensor(z)[None] for z in noise)
        return first(kernel(unit(state), delta, generator=generator, noise=noise))

    if hasattr(kernel, "batch_sharded"):
        one_kernel.batch_sharded = lambda mesh, axis="batch": one_chain(
            init, kernel.batch_sharded(mesh, axis))[1]
    return one_init, one_kernel


def one_chain_factories(dynamics_factory, *rest):
    """One chain's factories from a model's factories over time-first chains
    (`get_kernel`'s `chains`), which run at C = 1: x and u (T, d) go in as
    (T, 1, d), delta (a scalar or (T,)) as (1,) or (1, T), and the chain
    axis comes off what comes out (axis 1 of the per-step tensors; m0 and
    P0, every chain's, pass as they are). `rest` is the observation
    factories of (x, u, delta), then the target's log_likelihood_fn, whose
    (1,) becomes a scalar."""

    def dynamics(x):
        m0, P0, *steps = dynamics_factory(x[:, None])
        return (m0, P0, *(z[:, 0] for z in steps))

    def observations(factory):
        def one(x, u, delta):
            delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)[None]
            return tuple(z[:, 0] for z in factory(x[:, None], u[:, None], delta))
        return one

    def log_likelihood(x):
        return rest[-1](x[:, None])[0]

    return (dynamics, *map(observations, rest[:-1]), log_likelihood)


def _acceptance_probability(log_prop_fwd, log_prop_rev, log_target_prop,
                            log_target_rev, sqrt_delta, u, x, x_prop, per_chain=None):
    """Exact MH ratio for the auxiliary move, including the Gaussian pi(x | u)
    correction: summed over every axis, or with `per_chain` (time-first
    chains (T, K, d)) over time and state, then `per_chain` of the K
    columns' sums."""
    log_alpha = log_target_prop - log_target_rev
    log_alpha = log_alpha + (log_prop_rev - log_prop_fwd)
    diff_prop = (x_prop - u) / sqrt_delta
    diff = (x - u) / sqrt_delta
    sq = diff_prop ** 2 - diff ** 2
    log_alpha = log_alpha - (sq.sum() if per_chain is None else per_chain(sq.sum((0, 2))))
    return torch.exp(torch.clamp(log_alpha, max=0.0))
