"""Auxiliary particle-Gibbs kernel with generic (user-factory) proposals
(counterpart of `aux_ssm_tpu/kernels/csmc_aux.py`).

Each step draws the auxiliary observations u_t = x_t + sqrt(delta_t / 2) eps_t
(delta a scalar or a (T,) vector) and hands them to a factory that builds
the Feynman–Kac model (M0, G0, Mt, Gt) of the inner cSMC sweep. Under a
chain axis (x (C, T, d), `kernels/csmc.py`) delta is (C,) or (C, T) and the
factory gets u (C, T, d) and sqrt_half_delta (C, T).
"""
import torch

from .csmc import draw_noise, get_kernel as get_csmc_kernel
from .csmc_base import CSMCState
from ..ops import resampling as resampling_mod


def get_kernel(factory, N, backward=False, Pt=None, resampling="multinomial"):
    """Build an auxiliary PG kernel from `factory(u, sqrt_half_delta) ->
    (M0, G0, Mt, Gt)`, with u (T, d) and sqrt_half_delta (T,).

    Returns (init, kernel) with `kernel(state, delta, generator=None,
    noise=None) -> CSMCState`. `noise`, when given, holds every random
    number of the step in the JAX package's order: eps_aux (T, d), then the
    inner cSMC step's (eps_m0 (N, d), res_u (T-1, N), eps_prop (T-1, N, d),
    anc_u (T-1,), us (T,)).
    """
    if backward and Pt is None:
        raise ValueError("backward=True requires the true dynamics `Pt`.")
    if backward and not hasattr(Pt, "logpdf"):
        raise ValueError("`Pt` must implement a valid logpdf method.")
    resample = resampling_mod.get(resampling) if isinstance(resampling, str) else resampling

    def kernel(state, delta, generator=None, noise=None):
        x = state.x
        if noise is None:
            eps_aux = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            noise = (eps_aux,) + draw_noise(x, N, resample, generator)
        sqrt_half_delta = per_step_scale(delta, x)
        u = x + sqrt_half_delta[..., None] * noise[0]
        M0, G0, Mt, Gt = factory(u, sqrt_half_delta)
        _, csmc_kernel = get_csmc_kernel(M0, G0, Mt, Gt, N, backward=backward, Pt=Pt,
                                         resampling=resample)
        return csmc_kernel(state, noise=noise[1:])

    def init(x):
        return CSMCState(x=x, updated=torch.zeros(x.shape[:-1], dtype=torch.bool,
                                                  device=x.device))

    return init, kernel


def per_step_scale(delta, x):
    """sqrt(delta / 2) at every step of x (..., T, d): delta a scalar, (T,),
    or under a chain axis (C,) or (C, T)."""
    delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)
    if delta.dim() and delta.dim() < x.dim() - 1:  # one delta a chain
        delta = delta[..., None]
    return torch.sqrt(0.5 * delta).expand(x.shape[:-1])
