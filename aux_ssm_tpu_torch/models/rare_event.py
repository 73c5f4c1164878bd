"""Rare-event model: a stationary scalar AR(1) bridge conditioned on one
near-unreachable observation at the final step (counterpart of
`aux_ssm_tpu/models/rare_event.py`).

Model:  x_0 ~ N(0, 1),   x_{t+1} = rho x_t + sqrt(1 - rho^2) eps,
        one observation  y ~ N(x_{T-1}, r^2)  at the last step.

The conditional moments of x_0 and x_{T-1} given y are known in closed form
(`conditional_moments`), so the model is an exact oracle for its three
sampler styles:
    kalman        auxiliary Kalman MH (`get_kalman_kernel`), the MH kernels at d = 1
    csmc          auxiliary PG with independent proposals (`get_csmc_kernel`),
                  the factor sweeps, or with `parallel=True` (the default of
                  `experiments/cli.py`) the PIT cSMC through the stitching kernels
    csmc-guided   Kalman-gain guided auxiliary PG (`get_guided_csmc_kernel`),
                  the lane sweep with the functor `RareEventGuided`
y, rho, r2 are Python floats. The functions take `dtype` and `device`; the
chain's tensors must match them, and `device=None` is the card
(`device.default_device`).
"""
import math
from dataclasses import dataclass

import torch

from ..device import resolve
from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 diag_gaussian_pair_factors)
from ..kernels.kalman import get_kernel as get_kalman_generic
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


def _ar_params(rho, T, kw):
    m0 = torch.zeros(1, **kw)
    P0 = torch.eye(1, **kw)
    Fs = rho * torch.ones(T - 1, 1, 1, **kw)
    Qs = (1.0 - rho ** 2) * torch.ones(T - 1, 1, 1, **kw)
    bs = torch.zeros(T - 1, 1, **kw)
    return m0, P0, Fs, Qs, bs


def init_x(y, rho, r2, T, parallel=True, *, generator=None, eps=None, dtype=torch.float64,
           device=None):
    """An exact posterior draw (the model is an LGSSM with its one observation
    NaN-masked everywhere but the last step), to start a chain from. `eps`
    (T, 1) are the draw's standard normals (default: from `generator`)."""
    kw = dict(dtype=dtype, device=resolve(device))
    m0, P0, Fs, Qs, bs = _ar_params(rho, T, kw)
    Hs = torch.zeros(T, 1, 1, **kw)
    Hs[-1] = 1.0
    Rs = r2 * torch.ones(T, 1, 1, **kw)
    cs = torch.zeros(T, 1, **kw)
    ys = torch.full((T, 1), math.nan, **kw)
    ys[-1, 0] = y
    lgssm = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
    fms, fPs, _ = filtering(ys, lgssm, parallel)
    if eps is None:
        eps = torch.randn(T, 1, generator=generator, **kw)
    return sampling(eps, fms, fPs, lgssm, parallel)


def get_kalman_kernel(y, rho, r2, T, parallel, gradient=False, *, dtype=torch.float64,
                      device=None):
    """Auxiliary Kalman kernel; the potential acts only at the final step, so
    the gradient shift is non-zero only there. Returns (init, kernel) of
    `kernels.kalman.get_kernel`; `init` takes a (T,) or (T, 1) trajectory."""
    kw = dict(dtype=dtype, device=resolve(device))
    m0, P0, Fs, Qs, bs = _ar_params(rho, T, kw)
    sig_x = math.sqrt(1.0 - rho ** 2)
    r = math.sqrt(r2)
    Hs = torch.ones(T, 1, 1, **kw)
    cs = torch.zeros(T, 1, **kw)
    ones = torch.ones(T, 1, 1, **kw)
    zeros = torch.zeros(T, 1, **kw)
    last = torch.zeros(T, 1, **kw)
    last[-1] = 1.0

    def dynamics_factory(_x):
        return m0, P0, Fs, Qs, bs

    def observations_factory(x, u, delta):
        shift = last * ((y - x[-1]) / r2) if gradient else zeros
        aux_ys = u + 0.5 * delta * shift
        return aux_ys, Hs, 0.5 * delta * ones, cs

    def log_likelihood_fn(x):
        out = norm_logpdf(x[0, 0], 0.0, 1.0)
        out = out + norm_logpdf(x[1:, 0], rho * x[:-1, 0], sig_x).sum()
        return out + norm_logpdf(y, x[-1, 0], r)

    init_, kernel = get_kalman_generic(dynamics_factory, observations_factory,
                                       log_likelihood_fn, parallel)

    def init(xs):
        return init_(xs[:, None] if xs.dim() == 1 else xs)

    return init, kernel


# --------------------------------------------------------------------------
# Feynman–Kac components; per-step params are dicts of (T-1,) tensors
# --------------------------------------------------------------------------

def _lane(p):
    """One step's (or all steps') params aligned with (..., N) particle rows."""
    return {k: v[..., None] for k, v in p.items()}


def _rows_of(p, names):
    """The compact per-step rows of a CUDA lane functor: (T-1, len(names))."""
    dtype = p[names[0]].dtype
    return torch.stack([p[k].to(dtype) for k in names], 1)


@dataclass(frozen=True)
class RareM0(Distribution, UnivariatePotential):
    """x_0 ~ N(0, 1); as a potential, the observation when T = 1."""
    y: float
    r: float
    T: int

    def sample_from_noise(self, eps):
        return eps.clone()

    def logpdf(self, x):
        return norm_logpdf(x[..., 0], 0.0, 1.0)

    def __call__(self, x):
        return (self.T == 1) * norm_logpdf(x[..., 0], self.y, self.r)


@dataclass(frozen=True)
class RareG0(UnivariatePotential):
    y: float
    r: float
    T: int

    def __call__(self, x):
        return (self.T == 1) * norm_logpdf(x[..., 0], self.y, self.r)


@dataclass(frozen=True, kw_only=True)
class RareMt(Dynamics):
    """x_{t+1} = rho x_t + sig_x eps; params = dict(rho, sig), which only the
    lane callables read (as in the JAX package, where they must)."""
    rho: float
    sig_x: float
    cuda_model = "rare_event_bootstrap"

    def sample_from_noise(self, eps, x_t, params):
        return self.rho * x_t + self.sig_x * eps

    def logpdf(self, x_next, x_t, params):
        return norm_logpdf(x_next[..., 0], self.rho * x_t[..., 0], self.sig_x)

    def logpdf_factors(self, x_prev, x_next, params):
        return diag_gaussian_pair_factors(self.rho * x_prev, x_next, self.sig_x)

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


def get_feynman_kac(y, rho, r2, T, *, dtype=torch.float64, device=None):
    """The model through the cSMC interface (M0, G0, Mt, Gt): bootstrap
    proposals, indicator potentials acting only at the final step."""
    kw = dict(dtype=dtype, device=resolve(device))
    sig_x = math.sqrt(1.0 - rho ** 2)
    r = math.sqrt(r2)

    def full(z):
        return torch.full((T - 1,), z, **kw)

    Mt = RareMt(params=dict(rho=full(rho), sig=full(sig_x)), rho=rho, sig_x=sig_x)
    gt_params = dict(t=torch.arange(1, T, device=kw["device"]), y=full(y), r=full(r))
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
    """x_0 ~ N(mu, sig_p^2), the prior N(0, 1) combined with u_0."""
    mu: torch.Tensor
    sig_p: torch.Tensor

    def sample_from_noise(self, eps):
        return self.mu + self.sig_p * eps

    def logpdf(self, x):
        return norm_logpdf(x[..., 0], self.mu, self.sig_p)

    def __call__(self, x):
        return self.logpdf(x)


@dataclass(frozen=True)
class GuidedG0(UnivariatePotential):
    prop: GuidedM0
    u0: torch.Tensor
    scale0: torch.Tensor
    y: float
    r: float
    T: int

    def __call__(self, x):
        out = norm_logpdf(x[..., 0], 0.0, 1.0)
        out = out + norm_logpdf(x[..., 0], self.u0, self.scale0)
        out = out - self.prop.logpdf(x)
        return out + (self.T == 1) * norm_logpdf(x[..., 0], self.y, self.r)


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
    sig_x = math.sqrt(1.0 - rho ** 2)
    r = math.sqrt(r2)
    sig0s = torch.ones(T, **kw)        # prior scale per step
    sig0s[1:] = sig_x
    consts = torch.tensor([float(T), float(gradient)], dtype=torch.float64).to(**kw)
    fixed = {k: torch.full((T - 1,), z, **kw)
             for k, z in (("rho", rho), ("sig", sig_x), ("y", y), ("r", r), ("r2", r2))}
    fixed["t"] = torch.arange(1, T, **kw)

    def factory(u, scale):
        Ks = sig0s ** 2 / (sig0s ** 2 + scale ** 2)    # scalar gains
        sig_props = sig0s * torch.sqrt(1.0 - Ks)       # proposal scales
        g0 = (0 == T - 1) * (y - 0.0) / r2
        prop0 = GuidedM0(Ks[0] * (u[0, 0] + gradient * scale[0] ** 2 * g0), sig_props[0])
        params = dict(K=Ks[1:], sig_p=sig_props[1:], u=u[1:, 0], scale=scale[1:], **fixed)
        return (prop0, GuidedG0(prop0, u[0, 0], scale[0], y, r, T),
                GuidedMt(params=params, T=T, gradient=gradient),
                GuidedGt(params=params, T=T, gradient=gradient, consts=consts))

    return csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling)
