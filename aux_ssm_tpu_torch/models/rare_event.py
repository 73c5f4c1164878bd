"""Rare-event model: a stationary scalar AR(1) bridge conditioned on one
near-unreachable observation at the final step (counterpart of
`aux_ssm_tpu/models/rare_event.py`).

Model:  x_0 ~ N(0, 1),   x_{t+1} = rho x_t + sqrt(1 - rho^2) eps,
        one observation  y ~ N(x_{T-1}, r^2)  at the last step.

The conditional moments of x_0 and x_{T-1} given y are known in closed form
(`conditional_moments`), so the model is an exact oracle for its three
sampler styles:
    kalman        auxiliary Kalman MH (`get_kalman_kernel`) in the batched scalar
                  layout, the scalar scans (one cell is M = 1)
    csmc          auxiliary PG with independent proposals (`get_csmc_kernel`),
                  the factor sweeps, or with `parallel=True` (the default of
                  `experiments/cli.py`) the PIT cSMC through the stitching kernels
    csmc-guided   Kalman-gain guided auxiliary PG (`get_guided_csmc_kernel`),
                  the lane sweep with the functor `RareEventGuided`
y, rho, r2 are Python floats. The functions take `dtype` and `device`; the
chain's tensors must match them, and `device=None` is the card
(`device.default_device`).

Cells on a chain axis (the rare-event grid, `experiments/rare_event.py`):
given rho and r2 as (M,) tensors, every builder makes M chains at once, one
(rho, r2) cell each. `init_x` then draws (M, T, 1); the kalman kernel runs
in the batched scalar layout, x (T, M, 1) and delta (M,)
(`kernels.kalman.get_kernel(..., chains=True)`); the cSMC kernels take x
(M, T, 1) and delta (M,) or (M, T) (`kernels/csmc.py`'s chain axis), their
components' per-step params (M, T-1), the lane functors' rows (M, T-1, P)
and their constants [T] or [T, gradient] shared.
"""
import math
from dataclasses import dataclass

import torch

from ..device import resolve
from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 diag_gaussian_pair_factors)
from ..kernels.kalman import KalmanSampler, get_kernel as get_kalman_generic
from ..ops.filtering import filtering
from ..ops.lgssm import LGSSM
from ..ops.mvn import norm_logpdf
from ..ops.sampling import sampling


def conditional_moments(y, rho, r2, T):
    """Closed-form posterior moments ((mean_0, var_0), (mean_T, var_T)) of x_0
    and x_{T-1} given y."""
    rho_0T = rho ** (T - 1)
    mean_T = y / (1.0 + r2)
    var_T = r2 / (1.0 + r2)
    mean_0 = rho_0T * mean_T
    var_0 = rho_0T ** 2 * var_T + 1.0 - rho_0T ** 2
    return (mean_0, var_0), (mean_T, var_T)


def _cells(rho, r2, kw):
    """(rho, r2, sig_x, r, M): Python floats and M None for one cell, or (M,)
    tensors of kw's dtype and device for M cells."""
    if not (isinstance(rho, torch.Tensor) or isinstance(r2, torch.Tensor)):
        return rho, r2, math.sqrt(1.0 - rho ** 2), math.sqrt(r2), None
    rho, r2 = (torch.as_tensor(z, **kw).reshape(-1) for z in (rho, r2))
    rho, r2 = torch.broadcast_tensors(rho, r2)
    return rho, r2, torch.sqrt(1.0 - rho ** 2), torch.sqrt(r2), rho.shape[0]


def _chainwise(v, like):
    """A per-chain value (M,) aligned with the leading (chain) axis of `like`;
    a number or a 0-d tensor as it is."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - 1))


def _ar_params(rho, T, kw, M):
    """The AR(1) prior of M cells in the batched scalar layout."""
    col = (1, M, 1, 1)
    return (torch.zeros(M, 1, **kw), torch.ones(M, 1, 1, **kw),
            rho.reshape(col).expand(T - 1, M, 1, 1), (1.0 - rho ** 2).reshape(col).expand(
                T - 1, M, 1, 1), torch.zeros(T - 1, M, 1, **kw))


def _as_cells(rho, r2, kw):
    """`_cells` with one cell (float rho and r2) as M = 1: (rho, r2, sig_x,
    r, M, one), the four (M,) tensors and `one` whether it was one cell."""
    rho, r2, sig_x, r, M = _cells(rho, r2, kw)
    if M is not None:
        return rho, r2, sig_x, r, M, False
    return tuple(torch.tensor([z], **kw) for z in (rho, r2, sig_x, r)) + (1, True)


def init_x(y, rho, r2, T, parallel=True, *, generator=None, eps=None, dtype=torch.float64,
           device=None):
    """An exact posterior draw (the model is an LGSSM with its one observation
    NaN-masked everywhere but the last step), to start a chain from, through
    the batched scalar layout's filters. One cell (rho, r2 floats): (T, 1)
    from the (T, 1) normals `eps`; M cells (rho, r2 (M,)): one draw a cell,
    (M, T, 1), from the (M, T, 1) normals `eps` (default: from `generator`)."""
    kw = dict(dtype=dtype, device=resolve(device))
    rho, r2, _, _, M, one = _as_cells(rho, r2, kw)
    lgssm = LGSSM(*_ar_params(rho, T, kw, M), torch.zeros(T, M, 1, 1, **kw),
                  r2.reshape(1, M, 1, 1).expand(T, M, 1, 1), torch.zeros(T, M, 1, **kw))
    lgssm.Hs[-1] = 1.0
    ys = torch.full((T, M, 1), math.nan, **kw)
    ys[-1] = y
    fms, fPs, _ = filtering(ys, lgssm, parallel)
    if eps is None:
        eps = torch.randn(M, T, 1, generator=generator, **kw)
    x = sampling(eps.reshape(M, T, 1).transpose(0, 1), fms, fPs, lgssm, parallel)
    x = x.transpose(0, 1).contiguous()
    return x[0] if one else x


def get_kalman_kernel(y, rho, r2, T, parallel, gradient=False, *, dtype=torch.float64,
                      device=None):
    """Auxiliary Kalman kernel in the batched scalar layout, M chains of one
    cell each (one cell is M = 1); the potential acts only at the final step,
    so the gradient shift is non-zero only there. Returns (init, kernel) of
    `kernels.kalman.get_kernel(..., chains=True)`: for M cells (rho, r2 (M,)),
    `init` takes x (T, M, 1) and the kernel delta (M,); for one cell, `init`
    takes a (T,) or (T, 1) trajectory, the kernel a scalar delta and noise of
    (T, 1), (T, 1) and (), and the state holds x (T, 1) and a scalar
    `updated`."""
    kw = dict(dtype=dtype, device=resolve(device))
    rho, r2, sig_x, r, M, one = _as_cells(rho, r2, kw)
    m0, P0, Fs, Qs, bs = _ar_params(rho, T, kw, M)
    Hs = torch.ones(T, M, 1, 1, **kw)
    cs = torch.zeros(T, M, 1, **kw)
    last = torch.zeros(T, 1, 1, **kw)
    last[-1] = 1.0

    def dynamics_factory(_x):
        return m0, P0, Fs, Qs, bs

    def observations_factory(x, u, delta):
        half = 0.5 * delta
        shift = last * ((y - x[-1]) / r2[:, None]) if gradient else torch.zeros_like(u)
        aux_ys = u + half[:, None] * shift
        return aux_ys, Hs, half.reshape(1, M, 1, 1).expand(T, M, 1, 1), cs

    def log_likelihood_fn(x):
        out = norm_logpdf(x[0, :, 0], 0.0, 1.0)
        out = out + norm_logpdf(x[1:, :, 0], rho * x[:-1, :, 0], sig_x).sum(0)
        return out + norm_logpdf(y, x[-1, :, 0], r)

    init_, kernel_ = get_kalman_generic(dynamics_factory, observations_factory,
                                        log_likelihood_fn, parallel, chains=True)
    if not one:
        return init_, kernel_

    def reshaped(state, x_shape, scalar_shape):
        lt = state.log_target
        return KalmanSampler(x=state.x.reshape(x_shape),
                             updated=state.updated.reshape(scalar_shape),
                             log_target=None if lt is None else lt.reshape(scalar_shape))

    def init(xs):
        return reshaped(init_(xs.reshape(T, 1, 1)), (T, 1), ())

    def kernel(state, delta, generator=None, noise=None):
        x = state.x
        delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device).reshape(1)
        if noise is not None:
            eps_aux, eps_smooth, u_accept = noise
            noise = (eps_aux.reshape(T, 1, 1), eps_smooth.reshape(T, 1, 1),
                     torch.as_tensor(u_accept, dtype=x.dtype, device=x.device).reshape(1))
        out = kernel_(reshaped(state, (T, 1, 1), (1,)), delta, generator, noise)
        return reshaped(out, (T, 1), ())

    return init, kernel


# --------------------------------------------------------------------------
# Feynman–Kac components; per-step params are dicts of (T-1,) tensors
# --------------------------------------------------------------------------

def _lane(p):
    """One step's (or all steps') params aligned with (..., N) particle rows."""
    return {k: v[..., None] for k, v in p.items()}


def _rows_of(p, names):
    """The compact per-step rows of a CUDA lane functor: (T-1, len(names)),
    or (M, T-1, len(names)) for M cells."""
    dtype = p[names[0]].dtype
    return torch.stack([p[k].to(dtype) for k in names], -1)


@dataclass(frozen=True)
class RareM0(Distribution, UnivariatePotential):
    """x_0 ~ N(0, 1); as a potential, the observation when T = 1. `r` a float,
    or (M,) for M cells."""
    y: float
    r: object
    T: int

    def sample_from_noise(self, eps):
        return eps.clone()

    def logpdf(self, x):
        return norm_logpdf(x[..., 0], 0.0, 1.0)

    def __call__(self, x):
        return (self.T == 1) * norm_logpdf(x[..., 0], self.y, _chainwise(self.r, x[..., 0]))


@dataclass(frozen=True)
class RareG0(UnivariatePotential):
    y: float
    r: object
    T: int

    def __call__(self, x):
        return (self.T == 1) * norm_logpdf(x[..., 0], self.y, _chainwise(self.r, x[..., 0]))


@dataclass(frozen=True, kw_only=True)
class RareMt(Dynamics):
    """x_{t+1} = rho x_t + sig_x eps; params = dict(rho, sig), (T-1,) or for M
    cells (M, T-1): rho and sig ride the per-step params, as in the JAX
    package, where the grid's vmap over cells needs them there."""
    cuda_model = "rare_event_bootstrap"

    def sample_from_noise(self, eps, x_t, params):
        return params["rho"][..., None, None] * x_t + params["sig"][..., None, None] * eps

    def logpdf(self, x_next, x_t, params):
        p = _lane(params)
        return norm_logpdf(x_next[..., 0], p["rho"] * x_t[..., 0], p["sig"])

    def logpdf_factors(self, x_prev, x_next, params):
        return diag_gaussian_pair_factors(params["rho"][..., None, None] * x_prev, x_next,
                                          params["sig"][..., None, None])

    def lane_propagate(self, eps, x_prev, params):
        p = _lane(params)
        return p["rho"] * x_prev + p["sig"] * eps

    def lane_logpdf(self, x_next, x_prev, params):
        p = _lane(params)
        return norm_logpdf(x_next, p["rho"] * x_prev, p["sig"])


@dataclass(frozen=True, kw_only=True)
class RareGt(Potential):
    """The observation as an indicator of the last step times its density (a
    product, not a select); params = dict(t, y, r). `dyn` and `consts` ([T])
    serve the `rare_event_bootstrap` functor."""
    y: float
    T: int
    dyn: RareMt
    consts: torch.Tensor
    prev_dependent = False
    cuda_model = "rare_event_bootstrap"

    def __call__(self, x_next, x_t, params):
        p = _lane(params)
        return (p["t"] == self.T - 1) * norm_logpdf(self.y, x_next[..., 0], p["r"])

    def lane_logw(self, x_next, x_prev, params):
        p = _lane(params)
        return (p["t"] == self.T - 1) * norm_logpdf(p["y"], x_next, p["r"])

    def cuda_operands(self):
        """(constants, per-step rows [rho, sig, t, y, r])."""
        return self.consts, _rows_of({**self.dyn.params, **self.params},
                                     ("rho", "sig", "t", "y", "r"))


def _per_step(T, M, kw):
    """A number or an (M,) tensor on every step of 1..T-1: (T-1,), or (M, T-1)
    for M cells."""
    def full(z):
        if M is None:
            return torch.full((T - 1,), z, **kw)
        return torch.as_tensor(z, **kw).reshape(-1, 1).expand(M, T - 1)
    return full


def _steps(T, M, **kw):
    t = torch.arange(1, T, **kw)
    return t if M is None else t.expand(M, T - 1)


def get_feynman_kac(y, rho, r2, T, *, dtype=torch.float64, device=None):
    """The model through the cSMC interface (M0, G0, Mt, Gt): bootstrap
    proposals, indicator potentials acting only at the final step."""
    kw = dict(dtype=dtype, device=resolve(device))
    rho, r2, sig_x, r, M = _cells(rho, r2, kw)
    full = _per_step(T, M, kw)
    Mt = RareMt(params=dict(rho=full(rho), sig=full(sig_x)))
    gt_params = dict(t=_steps(T, M, device=kw["device"]), y=full(y), r=full(r))
    Gt = RareGt(params=gt_params, y=y, T=T, dyn=Mt, consts=torch.full((1,), float(T), **kw))
    return RareM0(y, r, T), RareG0(y, r, T), Mt, Gt


def get_csmc_kernel(y, rho, r2, T, n_particles, backward=True, parallel=False, gradient=False,
                    resampling="multinomial", *, dtype=torch.float64, device=None):
    """Auxiliary PG with independent proposals (style `csmc`); returns (init,
    kernel), `kernel(state, delta, generator=None, noise=None)`."""
    M0, G0, Mt, Gt = get_feynman_kac(y, rho, r2, T, dtype=dtype, device=device)
    return csmc_independent.get_kernel(M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
                                       gradient=gradient, parallel=parallel,
                                       resampling=resampling)


# --------------------------------------------------------------------------
# Guided cSMC: closed-form scalar Kalman gains
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GuidedM0(Distribution, UnivariatePotential):
    """x_0 ~ N(mu, sig_p^2), the prior N(0, 1) combined with u_0; mu and
    sig_p 0-d, or (M,) for M cells."""
    mu: torch.Tensor
    sig_p: torch.Tensor

    def sample_from_noise(self, eps):
        return _chainwise(self.mu, eps) + _chainwise(self.sig_p, eps) * eps

    def logpdf(self, x):
        x = x[..., 0]
        return norm_logpdf(x, _chainwise(self.mu, x), _chainwise(self.sig_p, x))

    def __call__(self, x):
        return self.logpdf(x)


@dataclass(frozen=True)
class GuidedG0(UnivariatePotential):
    prop: GuidedM0
    u0: torch.Tensor
    scale0: torch.Tensor
    y: float
    r: object
    T: int

    def __call__(self, x):
        xv = x[..., 0]
        out = norm_logpdf(xv, 0.0, 1.0)
        out = out + norm_logpdf(xv, _chainwise(self.u0, xv), _chainwise(self.scale0, xv))
        out = out - self.prop.logpdf(x)
        return out + (self.T == 1) * norm_logpdf(xv, self.y, _chainwise(self.r, xv))


def _guided_mu(x_pred, p, T, gradient):
    """The proposal mean from the per-step params only, on (..., N) rows."""
    g = (p["t"] == T - 1) * (p["y"] - x_pred) / p["r2"]
    su = p["u"] + gradient * p["scale"] ** 2 * g
    return x_pred + p["K"] * (su - x_pred)


@dataclass(frozen=True, kw_only=True)
class GuidedMt(Dynamics):
    """The guided proposal; params = dict(K, sig_p, u, scale, t, rho, sig, y,
    r, r2) of steps 1..T-1."""
    T: int
    gradient: bool
    cuda_model = "rare_event_guided"

    def sample_from_noise(self, eps, x_t, params):
        return self.lane_propagate(eps[..., 0], x_t[..., 0], params)[..., None]

    def logpdf(self, x_next, x_t, params):
        return self.lane_logpdf(x_next[..., 0], x_t[..., 0], params)

    def lane_propagate(self, eps, x_prev, params):
        p = _lane(params)
        return _guided_mu(p["rho"] * x_prev, p, self.T, self.gradient) + p["sig_p"] * eps

    def lane_logpdf(self, x_next, x_prev, params):
        p = _lane(params)
        mu = _guided_mu(p["rho"] * x_prev, p, self.T, self.gradient)
        return norm_logpdf(x_next, mu, p["sig_p"])


@dataclass(frozen=True, kw_only=True)
class GuidedGt(Potential):
    """The guided weight: N(x'; rho x, sig) N(x'; u, scale) / N(x'; mu, sig_p)
    and the observation at the last step; params as GuidedMt's. `consts` are
    the functor's constants [T, gradient]."""
    T: int
    gradient: bool
    consts: torch.Tensor
    cuda_model = "rare_event_guided"

    def __call__(self, x_next, x_t, params):
        return self.lane_logw(x_next[..., 0], x_t[..., 0], params)

    def lane_logw(self, x_next, x_prev, params):
        p = _lane(params)
        x_pred = p["rho"] * x_prev
        mu = _guided_mu(x_pred, p, self.T, self.gradient)
        out = norm_logpdf(x_next, x_pred, p["sig"])
        out = out + norm_logpdf(x_next, p["u"], p["scale"])
        out = out - norm_logpdf(x_next, mu, p["sig_p"])
        return out + (p["t"] == self.T - 1) * norm_logpdf(p["y"], x_next, p["r"])

    def cuda_operands(self):
        """(constants, per-step rows [K, sig_p, u, scale, t, rho, sig, y, r, r2])."""
        return self.consts, _rows_of(self.params, ("K", "sig_p", "u", "scale", "t", "rho",
                                                   "sig", "y", "r", "r2"))


def get_guided_csmc_kernel(y, rho, r2, T, n_particles, backward=True, gradient=False,
                           resampling="multinomial", *, dtype=torch.float64, device=None):
    """Guided proposals with closed-form scalar Kalman gains K = sig^2 /
    (sig^2 + delta / 2), recentring each step on the auxiliary observation
    (gradient-shifted at the final step when requested). Returns (init,
    kernel), `kernel(state, delta, generator=None, noise=None)`."""
    kw = dict(dtype=dtype, device=resolve(device))
    _, _, Pt, _ = get_feynman_kac(y, rho, r2, T, **kw)
    rho, r2, sig_x, r, M = _cells(rho, r2, kw)
    sig0s = torch.ones(T if M is None else (M, T), **kw)   # prior scale per step
    sig0s[..., 1:] = sig_x if M is None else sig_x[:, None]
    consts = torch.tensor([float(T), float(gradient)], dtype=torch.float64).to(**kw)
    full = _per_step(T, M, kw)
    fixed = {k: full(z) for k, z in (("rho", rho), ("sig", sig_x), ("y", y), ("r", r),
                                     ("r2", r2))}
    fixed["t"] = _steps(T, M, **kw)

    def factory(u, scale):
        Ks = sig0s ** 2 / (sig0s ** 2 + scale ** 2)    # scalar gains
        sig_props = sig0s * torch.sqrt(1.0 - Ks)       # proposal scales
        g0 = (0 == T - 1) * (y - 0.0) / r2
        prop0 = GuidedM0(Ks[..., 0] * (u[..., 0, 0] + gradient * scale[..., 0] ** 2 * g0),
                         sig_props[..., 0])
        params = dict(K=Ks[..., 1:], sig_p=sig_props[..., 1:], u=u[..., 1:, 0],
                      scale=scale[..., 1:], **fixed)
        return (prop0, GuidedG0(prop0, u[..., 0, 0], scale[..., 0], y, r, T),
                GuidedMt(params=params, T=T, gradient=gradient),
                GuidedGt(params=params, T=T, gradient=gradient, consts=consts))

    return csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling)
