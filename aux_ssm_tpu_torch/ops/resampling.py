"""Conditional resampling schemes for cSMC (counterpart of
`aux_ssm_tpu/ops/resampling.py`). Index 0 of every draw is pinned to 0, the
reference particle.

Every scheme runs from uniforms: `multinomial_from_uniforms` takes (N,)
uniforms, `systematic_from_uniforms` three; both, and the single draws,
take leading batch axes (a cSMC step's chains) on the uniforms and weights. `multinomial` and `systematic`
draw those uniforms from a `torch.Generator`. Inverse CDFs use
`torch.searchsorted(..., right=False)`, `jnp.searchsorted`'s `side='left'`:
the index of u is #{i : cdf[i] < u}.
"""
import torch


def _uniform(shape, like, generator):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def multinomial_from_uniforms(u, weights):
    """Conditional multinomial resampling from iid uniforms `u` (N,):
    inverse CDF of the (normalised) weights, index 0 pinned to 0. With
    leading axes, u (..., N) and weights (..., M) give one draw each."""
    idx = torch.searchsorted(torch.cumsum(weights, -1), u.contiguous())
    idx = idx.clamp(0, weights.shape[-1] - 1)
    idx[..., 0] = 0
    return idx


def categorical_from_uniform(u, weights):
    """One categorical draw by inverse CDF from the uniform `u` (a 0-d
    tensor); inverts u * total mass, so the weights need not be normalised.
    Returns a 0-d int64 tensor on the weights' device (no host sync). With
    leading axes, weights (..., N) and u (...) give one draw each (...)."""
    cdf = torch.cumsum(weights, -1)
    idx = torch.searchsorted(cdf, (u[..., None] * cdf[..., -1:]).contiguous())
    return idx.clamp(0, weights.shape[-1] - 1)[..., 0]


def choice_from_uniform(u, weights):
    """The index `jax.random.choice(key, M, p=weights)` draws from its
    uniform u: the inverse CDF at (1 - u) * total. Returns a (1,) int64
    tensor on the weights' device; with leading axes, u (...) and weights
    (..., M) give (..., 1)."""
    cdf = torch.cumsum(weights, -1)
    idx = torch.searchsorted(cdf, (cdf[..., -1:] * (1 - u)[..., None]).contiguous())
    return idx.clamp_(max=weights.shape[-1] - 1)


def systematic_from_uniforms(u, weights, N=None):
    """Conditional systematic resampling from three uniforms `u` (3,); with
    leading axes, u (..., 3) and weights (..., M) give one draw each."""
    return _systematic_core(u[..., 0], u[..., 1], u[..., 2], weights, N)


def _systematic_core(u_mix, u_off, u_rot, weights, N=None):
    """Chopin & Singh (2015), Alg. 4: conditioned on at least one copy of
    particle 0, the offset is a two-component uniform mixture; a uniformly
    chosen copy of particle 0 is then rotated into slot 0. The uniforms (...)
    and weights (..., M) may carry leading axes."""
    M = weights.shape[-1]
    N = M if N is None else N

    copies = N * weights[..., 0]
    whole = torch.floor(copies)
    part = copies - whole

    pick_low = u_mix * copies < part * (whole + 1.0)
    offset = torch.where(pick_low, part * u_off, part + (1.0 - part) * u_off)
    # If w_0 underflowed to exactly 0, "at least one copy of particle 0" has
    # numerical probability 0: force offset 0 so slot 0 still maps to index 0.
    offset = torch.where(copies > 0.0, offset, torch.zeros_like(offset))

    positions = (offset[..., None] + torch.arange(N, dtype=weights.dtype,
                                                  device=weights.device)) / N
    idx = torch.searchsorted(torch.cumsum(weights, -1), positions.contiguous())

    n0 = (idx == 0).sum(-1).to(weights.dtype)
    chosen = torch.floor(n0 * u_rot).long()
    # jnp.roll(idx, -chosen) without a host read of `chosen`.
    ar = torch.arange(N, device=weights.device)
    idx = torch.gather(idx, -1, (ar + chosen[..., None]) % N).clamp(0, M - 1)
    idx[..., 0] = 0
    return idx


def multinomial(weights, generator=None, N=None):
    """Conditional multinomial resampling with uniforms from `generator`."""
    N = weights.shape[0] if N is None else N
    return multinomial_from_uniforms(_uniform((N,), weights, generator), weights)


def systematic(weights, generator=None, N=None):
    """Conditional systematic resampling with uniforms from `generator`."""
    u = _uniform((3,), weights, generator)
    return _systematic_core(u[0], u[1], u[2], weights, N)


def get(name):
    """Look up a resampling scheme by name ('multinomial' | 'systematic')."""
    try:
        return {"multinomial": multinomial, "systematic": systematic}[name]
    except KeyError:
        raise ValueError(f"unknown resampling scheme: {name!r}") from None
