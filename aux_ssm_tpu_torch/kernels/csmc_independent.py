"""Auxiliary particle Gibbs with independent per-time-step Gaussian
proposals (counterpart of `aux_ssm_tpu/kernels/csmc_independent.py`): the
sequential inner cSMC, or with `parallel=True` the parallel-in-time one
(`kernels/pit.py`).

Given a Feynman–Kac model (M0, G0, Mt, Gt) and auxiliary observations
u_t = x_t + s_t eps with s_t = sqrt(delta_t / 2), the inner cSMC proposes
x_t ~ N(u_t + shift_t, s_t^2 I) independently of x_{t-1}
(shift_t = s_t^2 grad_t log pi(u) when `gradient=True`, else 0), and its
potentials absorb the model density and the closed-form proposal ratio

    corr(x) = sum_d shift_d (shift_d - 2 (x_d - u_d)) / (2 s^2).

Independent proposals with a pair-factorising weight make the forward
sweep the factor kernel (`ops/cuda/csmc_fwd.forward_factor_scan`), and the
PIT tree's stitching the stitching kernels (`ops/cuda/stitching.py`).
Both paths take a chain axis (x (C, T, d), delta (C,) or (C, T); see
`kernels/csmc.py` and `kernels/pit.py`).
"""
import math
from dataclasses import dataclass
from typing import Any

import torch

from . import pit
from .csmc_aux import get_kernel as get_aux_kernel, per_step_scale
from .csmc_base import CSMCState, Distribution, Dynamics, Potential, UnivariatePotential

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def get_kernel(M0, G0, Mt, Gt, N, backward=False, Pt=None, gradient=False, parallel=False,
               resampling="multinomial", stitch="auto", draws="joint", block_max="row",
               mesh=None, mesh_axis=None):
    """Auxiliary PG kernel with independent per-step proposals; returns
    (init, kernel) with `kernel(state, delta, generator=None, noise=None)`;
    delta a scalar or a (T,) vector. `parallel=False`: the sequential sweep
    (see `csmc_aux.get_kernel` for its noise). `parallel=True`: the PIT
    cSMC (`_pit_path`; `stitch` forces its stitching route, `draws` picks
    the blocked route's draws and `block_max` block_masses' stabiliser, see
    `kernels/pit.py`; `backward`, `Pt` and `resampling` do not apply). With
    `mesh`, one chain's PIT step over `mesh[mesh_axis]`
    (`kernels/pit_sharded.py`): "particles" splits each level's block
    masses, "time" the tree."""
    pit.check_routes(stitch, draws, block_max)
    if parallel:
        return _pit_path(M0, G0, Mt, Gt, N, gradient, stitch, draws, block_max, mesh,
                         mesh_axis)
    if mesh is not None:
        raise ValueError("a mesh applies to the parallel-in-time path (parallel=True)")
    return _sequential_path(M0, G0, Mt, Gt, N, backward, Pt, gradient, resampling)


def trajectory_logpdf(u, M0, G0, Mt, Gt):
    """log of the unnormalised Feynman–Kac density along one trajectory u
    (T, d), or one a chain of u (C, T, d) -> (C,); differentiable in u."""
    head = M0.logpdf(u[..., 0, :]) + G0(u[..., 0, :])
    nxt, cur = u[..., 1:, None, :], u[..., :-1, None, :]  # one particle per step
    pair = Mt.logpdf(nxt, cur, Mt.params) + Gt(nxt, cur, Gt.params)
    return head + pair.sum((-2, -1))


def _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient):
    """loc_t = u_t + shift_t, shift_t = scale_t^2 grad_t log pi(u) (zero when
    `gradient` is off)."""
    if not gradient:
        return u, torch.zeros_like(u)
    with torch.enable_grad():
        v = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(trajectory_logpdf(v, M0, G0, Mt, Gt).sum(), v)
    shift = (scale ** 2)[..., None] * g
    return u + shift, shift


def _sequential_path(M0, G0, Mt, Gt, N, backward, Pt, gradient, resampling):
    def factory(u, scale):
        loc, shift = _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient)
        prop0 = DiagonalGaussian(loc=loc[..., 0, :], scale=scale[..., 0])
        propt = IndependentDynamics(params=(loc[..., 1:, :], scale[..., 1:]))
        g0 = AbsorbedG0(prior=M0, pot=G0, u=u[..., 0, :], shift=shift[..., 0, :],
                        scale=scale[..., 0])
        gt = AbsorbedGt(trans=Mt, pot=Gt, params=(Mt.params, Gt.params, (
            u[..., 1:, :], shift[..., 1:, :], scale[..., 1:])))
        return prop0, g0, propt, gt

    return get_aux_kernel(factory, N, backward, Pt, resampling)


def _pit_path(M0, G0, Mt, Gt, N, gradient, stitch, draws, block_max="row", mesh=None,
              mesh_axis=None):
    """Parallel-in-time execution: the proposals N(u_t + shift_t, s_t^2 I) are
    one time-batched distribution; the gradient correction enters through
    the importance distribution Qt = N(u, s^2 I), not the potentials.

    `noise = (eps_u (T, d), eps (T, N, d), levels, root)` in the JAX
    package's draw order: the auxiliary draw's normals, the proposals'
    normals, and the tree's noise (`pit` module docstring); drawn from
    `generator` when not given."""
    def kernel(state, delta, generator=None, noise=None):
        x = state.x
        *lead, T, d = x.shape
        if noise is None:
            kw = dict(generator=generator, dtype=x.dtype, device=x.device)
            noise = (torch.randn(x.shape, **kw), torch.randn(*lead, T, N, d, **kw)) \
                + pit.draw_noise(T, N, x, generator, chains=lead[0] if lead else None)
        eps_u, eps, levels, root = noise
        scale = per_step_scale(delta, x)
        u = x + scale[..., None] * eps_u
        loc, _ = _proposal_geometry(u, scale, M0, G0, Mt, Gt, gradient)
        proposals = DiagonalGaussian(loc=loc, scale=scale)
        qt = DiagonalGaussian(loc=u, scale=scale) if gradient else None
        zeros_d = torch.zeros_like(u[..., 0, :])
        g0 = AbsorbedG0(prior=M0, pot=G0, u=zeros_d, shift=zeros_d,
                        scale=torch.ones_like(scale[..., 0]))
        gt = AbsorbedGt(trans=Mt, pot=Gt,
                        params=(Mt.params, Gt.params, (torch.zeros_like(u[..., 1:, :]),
                                                       torch.zeros_like(u[..., 1:, :]),
                                                       torch.ones_like(scale[..., 1:]))))
        if mesh is None:
            _, pit_kernel = pit.get_kernel(proposals, g0, gt, N, qt, stitch=stitch, draws=draws,
                                           block_max=block_max)
        else:
            from . import pit_sharded
            from ..parallel.mesh import PARTICLES
            if mesh_axis == PARTICLES:
                _, pit_kernel = pit_sharded.get_particle_sharded_kernel(
                    proposals, g0, gt, N, mesh, qt, draws=draws, stitch=stitch,
                    block_max=block_max)
            else:
                _, pit_kernel = pit_sharded.get_sharded_kernel(proposals, g0, gt, N, mesh, qt,
                                                               mesh_axis, stitch, draws)
        return pit_kernel(state, noise=(eps, levels, root))

    def init(x):
        return CSMCState(x=x, updated=torch.zeros(x.shape[:-1], dtype=torch.bool,
                                                  device=x.device))

    return init, kernel


# --------------------------------------------------------------------------
# Building blocks (broadcast convention of `csmc_base`)
# --------------------------------------------------------------------------

def _diag_gauss_logpdf(x, loc, scale):
    """N(x; loc, scale^2 I) reduced over the state axis; loc (..., d) and the
    scalar scale (...) broadcast against particles (..., N, d)."""
    if x.dim() > loc.dim():
        loc, scale = loc.unsqueeze(-2), scale[..., None]
    z = (x - loc) / scale[..., None]
    d = x.shape[-1]
    return -0.5 * (z * z).sum(-1) - d * (torch.log(scale) + _HALF_LOG_2PI)


def _shift_correction(x, u, shift, scale):
    """log N(x; u, s^2 I) - log N(x; u + shift, s^2 I), in closed form."""
    if x.dim() > u.dim():
        u, shift, scale = u.unsqueeze(-2), shift.unsqueeze(-2), scale[..., None]
    num = shift * (shift - 2.0 * (x - u))
    return num.sum(-1) / (2.0 * scale ** 2)


@dataclass(frozen=True)
class DiagonalGaussian(Distribution):
    """N(loc, scale^2 I) over one time step: loc (d,), scale a scalar; with
    loc (T, d) and scale (T,) the time-batched proposals of the PIT kernel
    (particles (T, N, d))."""
    loc: torch.Tensor
    scale: torch.Tensor

    def sample_from_noise(self, eps):
        loc, scale = self.loc, self.scale
        if eps.dim() > loc.dim():
            loc, scale = loc.unsqueeze(-2), scale[..., None]
        return loc + scale[..., None] * eps

    def logpdf(self, x):
        return _diag_gauss_logpdf(x, self.loc, self.scale)


@dataclass(frozen=True)
class IndependentDynamics(Dynamics):
    """Time-indexed independent Gaussian proposals behind the Dynamics
    interface (x_t is ignored); params = (loc (T-1, d), scale (T-1,)).
    `independent = True` lets the forward sweep run as the factor kernel."""
    independent = True

    def sample_from_noise(self, eps, x_t, params):
        loc, scale = params
        if eps.dim() > loc.dim():
            loc, scale = loc.unsqueeze(-2), scale[..., None]
        return loc + scale[..., None] * eps

    def logpdf(self, x_next, x_t, params):
        loc, scale = params
        return _diag_gauss_logpdf(x_next, loc, scale)


@dataclass(frozen=True)
class AbsorbedG0(UnivariatePotential):
    """Initial weight: p0 . G0 times the auxiliary-vs-proposal ratio."""
    prior: Any
    pot: Any
    u: torch.Tensor
    shift: torch.Tensor
    scale: torch.Tensor

    def __call__(self, x):
        base = self.pot(x) + self.prior.logpdf(x)
        return base + _shift_correction(x, self.u, self.shift, self.scale)


@dataclass(frozen=True)
class AbsorbedGt(Potential):
    """Transition weight: model transition density . Gt times the
    auxiliary-vs-proposal ratio; params = (trans_params, pot_params,
    (u_t, shift_t, scale_t))."""
    trans: Any = None
    pot: Any = None

    def __call__(self, x_next, x_t, params):
        trans_params, pot_params, (u, shift, scale) = params
        base = self.trans.logpdf(x_next, x_t, trans_params)
        base = base + self.pot(x_next, x_t, pot_params)
        return base + _shift_correction(x_next, u, shift, scale)

    @property
    def supports_pairwise_factors(self):
        """The transition factorises (Gaussian) and the potential reads only
        x_{t+1}."""
        return (hasattr(self.trans, "logpdf_factors")
                and not getattr(self.pot, "prev_dependent", True))

    def pairwise_factors(self, x_left, x_right, params):
        """Factorise self(x_right[j], x_left[i], params) over all pairs as
        row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j]."""
        trans_params, pot_params, (u, shift, scale) = params
        rf, cf, rb, cb = self.trans.logpdf_factors(x_left, x_right, trans_params)
        cb = cb + self.pot(x_right, x_right, pot_params)
        cb = cb + _shift_correction(x_right, u, shift, scale)
        return rf, cf, rb, cb
