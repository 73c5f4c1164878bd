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
               chains=False):
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
        C independent chains of a scalar-state model at once, in the batched
        scalar layout (`ops/lgssm.py`): x (T, C, 1), delta (C,), the
        factories' proposal model in that layout and `log_likelihood_fn(x)`
        one target value a chain (C,). Each chain has its own proposal and
        target densities (nothing is summed over C) and its own accept; a
        step launches the scalar scans (`ops/cuda/scalar_scan.py`) as one
        chain's step does, whatever C is.

    Returns
    -------
    (init, kernel): `init(x) -> KalmanSampler` and
    `kernel(state, delta, generator=None, noise=None) -> KalmanSampler`.
    `noise`, if given, is `(eps_aux (T, dx), eps_smooth (T, dx), u_accept)`
    (with `chains`: (T, C, 1), (T, C, 1), (C,)) and replaces the draws from
    `generator`; the step accepts when `u_accept < alpha`, exactly as
    `jax.random.bernoulli`.
    """
    # With `chains`, delta (C,) lines up with the chain axis of (T, C, 1).
    per_step = (lambda d: d[:, None]) if chains else (lambda d: d)

    def propose(delta, eps, u, x, x_eval=None, log_target=None):
        """Build the proposal LGSSM at x; sample from it unless `x_eval` is
        given (reverse-move density evaluation). Returns the proposal logpdf,
        the target log-density at `x_eval` (reusing `log_target` when the
        caller knows it), and the sampled or given trajectory."""
        m0, P0, Fs, Qs, bs = dynamics_factory(x)[:5]
        ys, Hs, Rs, cs = observations_factory(x, u, delta)[:4]
        lgssm = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
        ms, Ps, ell = filtering(ys, lgssm, parallel, keep_batch=chains)
        if x_eval is None:
            x_eval = sampling(eps, ms, Ps, lgssm, parallel)
        log_prop = posterior_logpdf(ys, x_eval, ell, lgssm, keep_batch=chains)
        if log_target is None:
            log_target = log_likelihood_fn(x_eval)
        return log_prop, log_target, x_eval

    def kernel(state, delta, generator=None, noise=None):
        x = state.x
        delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)
        if noise is None:
            kw = dict(generator=generator, dtype=x.dtype, device=x.device)
            noise = (torch.randn(x.shape, **kw), torch.randn(x.shape, **kw),
                     torch.rand(x.shape[1:2] if chains else (), **kw))
        eps_aux, eps_smooth, u_accept = noise
        sqrt_delta = torch.sqrt(per_step(delta))

        u = x + torch.sqrt(0.5 * per_step(delta)) * eps_aux
        log_prop_fwd, log_target_prop, x_prop = propose(delta, eps_smooth, u, x)
        log_prop_rev, log_target_rev, _ = propose(
            delta, None, u, x_prop, x, log_target=state.log_target)

        alpha = _acceptance_probability(log_prop_fwd, log_prop_rev, log_target_prop,
                                        log_target_rev, sqrt_delta, u, x, x_prop,
                                        dims=(0, 2) if chains else None)
        accept = u_accept < alpha
        x_new = torch.where(per_step(accept), x_prop, x)
        lt_new = (None if state.log_target is None
                  else torch.where(accept, log_target_prop, log_target_rev))
        return KalmanSampler(x=x_new, updated=accept, log_target=lt_new)

    def init(x):
        return KalmanSampler(x=x, updated=torch.ones(x.shape[1:2] if chains else (),
                                                     dtype=torch.bool, device=x.device),
                             log_target=log_likelihood_fn(x))

    return init, kernel


def _acceptance_probability(log_prop_fwd, log_prop_rev, log_target_prop,
                            log_target_rev, sqrt_delta, u, x, x_prop, dims=None):
    """Exact MH ratio for the auxiliary move, including the Gaussian pi(x | u)
    correction, summed over `dims` (default: every axis)."""
    log_alpha = log_target_prop - log_target_rev
    log_alpha = log_alpha + (log_prop_rev - log_prop_fwd)
    diff_prop = (x_prop - u) / sqrt_delta
    diff = (x - u) / sqrt_delta
    sq = diff_prop ** 2 - diff ** 2
    log_alpha = log_alpha - (sq.sum() if dims is None else sq.sum(dims))
    return torch.exp(torch.clamp(log_alpha, max=0.0))
