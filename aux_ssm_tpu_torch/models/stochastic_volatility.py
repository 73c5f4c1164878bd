"""Multivariate stochastic-volatility model (counterpart of
`aux_ssm_tpu/models/stochastic_volatility.py`).

Model: D-dimensional log-volatility AR(1)
    x_0 ~ N(mu, Q_inf),   x_{t+1} = mu + phi (x_t - mu) + eps,  eps ~ N(0, Q)
    y_t | x_t ~ N(0, diag(exp(x_t)))
with Q the stationary covariance tau ((1-rho) I + rho 11^T) / (1 - phi^2).

Sampler styles:
    kalman-1      first-order auxiliary Kalman (`get_kalman_kernel`, order 1)
    kalman-2      second-order auxiliary Kalman on the potential's diagonal
                  Hessian (order 2); both run the dense d x d MH step, whose
                  kernels take d <= 32 (the published D = 30 on the D = 32
                  instance)
    csmc          auxiliary PG with independent proposals (optionally
                  gradient-shifted): the factor sweeps, or with
                  `parallel=True` (the default of `experiments/cli.py`) the
                  PIT cSMC through the stitching kernels
    csmc-guided   Kalman-gain guided auxiliary PG

Constant factorisations (Cholesky, eigendecomposition) are computed once,
in float64 on the CPU, then cast to the data's dtype and device, so the card
and the CPU use the same ones. Functions that take a `device` allocate on the
card when it is None (`device.default_device`).
"""
import math
from dataclasses import dataclass

import torch

from ..device import resolve
from ..kernels import csmc_aux, csmc_independent
from ..kernels.kalman import (chain_delta, chain_major, get_kernel as get_kalman_generic,
                              one_chain_factories)
from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 chol_gaussian_pair_factors, mark_chains, rows as _rows,
                                 shared_by_chains)
from ..ops import mvn
from ..ops.mvn import norm_logpdf as _norm_logpdf
from ..ops.resampling import choice_from_uniform

_LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------------
# Model definition
# --------------------------------------------------------------------------

def stationary_covariance(phi, tau, rho, dim, *, dtype=torch.float64, device=None):
    """tau ((1-rho) I + rho 11^T) / (1 - phi^2)."""
    device = resolve(device)
    U = tau * (rho * torch.ones(dim, dim, dtype=dtype, device=device)
               + (1.0 - rho) * torch.eye(dim, dtype=dtype, device=device))
    return U / (1.0 - phi ** 2)


def get_dynamics(nu, phi, tau, rho, dim, *, dtype=torch.float64, device=None):
    """LGSSM dynamics (m0, P0, F, Q, b) of the log-volatility chain."""
    device = resolve(device)
    F = phi * torch.eye(dim, dtype=dtype, device=device)
    Q = stationary_covariance(phi, tau, rho, dim, dtype=dtype, device=device)
    mu = nu * torch.ones(dim, dtype=dtype, device=device)
    return mu, Q, F, Q, mu - phi * mu


def _cast(like, *tensors):
    return tuple(z.to(dtype=like.dtype, device=like.device) for z in tensors)


def _factored_dynamics(nu, phi, tau, rho, like):
    """(m0, chol_P0, F, Q, chol_Q, b) factored in float64 on the CPU, cast to
    `like`'s dtype and device."""
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, like.shape[-1], device="cpu")
    return _cast(like, m0, torch.linalg.cholesky(P0), F, Q, torch.linalg.cholesky(Q), b)


def get_data(nu, phi, tau, rho, dim, T, *, generator=None, dtype=torch.float64, device=None):
    """Simulate (xs, ys), each (T, dim), with normals from `generator` (a CPU
    generator: the simulation runs in float64 on the CPU, and the result is
    moved to `device`)."""
    device = resolve(device)
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, dim, device="cpu")
    chol_P0, chol_Q = torch.linalg.cholesky(P0), torch.linalg.cholesky(Q)
    eps = torch.randn(2 * T + 1, dim, generator=generator, dtype=torch.float64)
    x = m0 + chol_P0 @ eps[0]
    xs = []
    for t in range(T):
        xs.append(x)
        x = F @ x + b + chol_Q @ eps[1 + t]
    xs = torch.stack(xs)
    ys = torch.exp(0.5 * xs) * eps[T + 1:]
    return xs.to(dtype=dtype, device=device), ys.to(dtype=dtype, device=device)


def _log_potential_one(x, y):
    # An infinite scale contributes 0 instead of NaN.
    return torch.nan_to_num(_norm_logpdf(y, 0.0, torch.exp(0.5 * x)))


def log_potential(xs, ys):
    """log p(y_{0:T} | x_{0:T}) = sum_t sum_d log N(y; 0, exp(x))."""
    return _log_potential_one(xs, ys).sum()


def grad_log_potential(xs, ys):
    """Gradient of `log_potential` in xs, elementwise in closed form:
    d/dx log N(y; 0, exp(x)) = y^2 exp(-x) / 2 - 1 / 2, NaN (a missing y) to
    0 and +-inf to the type's largest values, as the JAX package's
    `jnp.nan_to_num(jax.grad(log_potential))`."""
    return torch.nan_to_num(0.5 * ys ** 2 * torch.exp(-xs) - 0.5)


def hess_log_potential_diag(xs, ys):
    """Diagonal of the potential's Hessian, elementwise (the model is
    separable): d^2/dx^2 log N(y; 0, exp(x)) = -y^2 exp(-x) / 2."""
    return -0.5 * ys ** 2 * torch.exp(-xs)


def init_x_fn(ys, nu, phi, tau, rho, N, generator=None, noise=None):
    """Initial trajectory: a bootstrap particle filter with systematic
    resampling, then one backward-sampled trajectory (the JAX package's
    `init_x_fn`). `noise = (eps0 (N, d), u_sys (T,), eps (T, N, d), u_last (),
    u_back (T-1,))`: the initial normals, the systematic offsets, the
    propagation normals, and the uniforms of the final and backward draws
    (each a `jax.random.choice` draw: inverse CDF at (1 - u) * total)."""
    T, d = ys.shape
    m0, chol_P0, F, _, chol_Q, b = _factored_dynamics(nu, phi, tau, rho, ys)
    if noise is None:
        kw = dict(generator=generator, dtype=ys.dtype, device=ys.device)
        noise = (torch.randn(N, d, **kw), torch.rand(T, **kw), torch.randn(T, N, d, **kw),
                 torch.rand((), **kw), torch.rand(T - 1, **kw))
    eps0, u_sys, eps, u_last, u_back = noise

    x = m0 + eps0 @ chol_P0.T
    grid0 = torch.arange(N, dtype=ys.dtype, device=ys.device)
    xs, log_ws = [], []
    for t in range(T):
        log_w = _log_potential_one(x, ys[t]).sum(-1)
        log_w = log_w - torch.logsumexp(log_w, 0)
        anc = torch.searchsorted(torch.cumsum(torch.exp(log_w), 0), (u_sys[t] + grid0) / N)
        xs.append(x)
        log_ws.append(log_w)
        x = b + x[anc.clamp_(max=N - 1)] @ F.T + eps[t] @ chol_Q.T

    x_next = xs[-1][choice_from_uniform(u_last, torch.exp(log_ws[-1]))][0]
    traj = [x_next]
    for t in range(T - 2, -1, -1):
        lw = log_ws[t] + mvn.logpdf(x_next, b + xs[t] @ F.T, chol_Q)
        w = torch.exp(lw - torch.logsumexp(lw, 0))
        x_next = xs[t][choice_from_uniform(u_back[t], w)][0]
        traj.append(x_next)
    return torch.stack(traj[::-1])


# --------------------------------------------------------------------------
# Auxiliary Kalman samplers (styles kalman-1 / kalman-2)
# --------------------------------------------------------------------------

def get_kalman_factories(ys, nu, phi, tau, rho, chains=False):
    """The auxiliary-Kalman pieces on the data's dtype and device:
    (dynamics_factory, first_order_factory, second_order_factory,
    log_likelihood_fn) for `kernels.kalman.get_kernel`. Order 1 shifts the
    auxiliary observation by the potential's gradient; order 2 takes the
    diagonal second-order expansion Omega = (-H + 2 I / delta)^{-1}. The
    target's density is plain torch (the prior by triangular solves, the
    potential elementwise).

    The factories serve C chains on the same data at once, time first (x
    (T, C, D), delta (C,) or (C, T); the dense batched layout of
    `ops/lgssm.py`): m0, P0, F, Q, b, H and c are every chain's ((T[-1], 1,
    ...): the kernels read them once for all chains), u, the gradients, the
    Hessians, R and the auxiliary observations each chain's own, and
    `log_likelihood_fn` gives one value a chain (C,). Without `chains`, they
    are one chain's: the same factories at C = 1 (`one_chain_factories`)."""
    T, d = ys.shape
    m0, chol_P0, F, Q, chol_Q, b = _factored_dynamics(nu, phi, tau, rho, ys)
    # The kernels take contiguous per-step arrays: made once, not per call;
    # a unit chain axis on what every chain shares.
    Fs, Qs = F.expand(T - 1, 1, d, d).contiguous(), Q.expand(T - 1, 1, d, d).contiguous()
    bs = b.expand(T - 1, 1, d).contiguous()
    eyes = torch.eye(d, dtype=ys.dtype, device=ys.device).expand(T, 1, d, d).contiguous()
    zeros = ys.new_zeros(T, 1, d)
    data = ys[:, None]

    def dynamics_factory(_x):
        return m0, Q, Fs, Qs, bs  # P0 = Q, the stationary covariance

    def first_order_factory(x, u, delta):
        half = 0.5 * chain_delta(delta)
        aux_ys = u + half * grad_log_potential(x, data)
        return aux_ys, eyes, half[..., None] * eyes, zeros

    def second_order_factory(x, u, delta):
        dl = chain_delta(delta)
        hess = torch.nan_to_num(hess_log_potential_diag(x, data))
        omega = 1.0 / (-hess + 2.0 / dl)
        aux_ys = omega * (2.0 * u / dl + grad_log_potential(x, data) - hess * x)
        return aux_ys, eyes, omega[..., None] * eyes, zeros

    def log_likelihood_fn(x):
        out = mvn.logpdf(x[0], m0, chol_P0)
        trans = mvn.logpdf(x[1:], x[:-1] @ F.T + b, chol_Q)
        return out + trans.sum(0) + _log_potential_one(x, data).sum((0, 2))

    factories = (dynamics_factory, first_order_factory, second_order_factory, log_likelihood_fn)
    return factories if chains else one_chain_factories(*factories)


def get_kalman_kernel(ys, nu, phi, tau, rho, parallel, order=1, chains=False):
    """Auxiliary Kalman kernel (style kalman-1 for `order` 1, kalman-2 for
    2); returns (init, kernel) of `kernels.kalman.get_kernel`. With `chains`,
    C chains as one batched step over a leading chain axis (`chain_major`):
    `init(x (C, T, D))`, the kernel's state x (C, T, D), delta (C,) or (C,
    T), noise ((C, T, D), (C, T, D), (C,)); each of the six MH kernels
    launches as often a step as for one chain."""
    dyn, first, second, target = get_kalman_factories(ys, nu, phi, tau, rho, chains)
    init, kernel = get_kalman_generic(dyn, first if order == 1 else second, target, parallel,
                                      chains=chains)
    return chain_major(init, kernel) if chains else (init, kernel)


# --------------------------------------------------------------------------
# Feynman–Kac components (cSMC styles); broadcast convention of `csmc_base`
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SvPrior(Distribution, UnivariatePotential):
    """x_0 ~ N(m0, chol_P0 chol_P0^T); also its own log-density potential."""
    m0: torch.Tensor
    chol_P0: torch.Tensor

    def sample_from_noise(self, eps):
        return self.m0 + eps @ self.chol_P0.T

    def logpdf(self, x):
        return mvn.logpdf(x, self.m0, self.chol_P0)

    def __call__(self, x):
        return self.logpdf(x)


@dataclass(frozen=True, kw_only=True)
class SvTransition(Dynamics):
    """x_{t+1} ~ N(F x_t + b, chol_Q chol_Q^T); params unused (T-1, 0)."""
    F: torch.Tensor
    b: torch.Tensor
    chol_Q: torch.Tensor

    def sample_from_noise(self, eps, x_t, params):
        return x_t @ self.F.T + self.b + eps @ self.chol_Q.T

    def logpdf(self, x_next, x_t, params):
        return mvn.logpdf(x_next, x_t @ self.F.T + self.b, self.chol_Q)

    def logpdf_factors(self, x_prev, x_next, params):
        return chol_gaussian_pair_factors(x_prev @ self.F.T + self.b, x_next, self.chol_Q)


@dataclass(frozen=True)
class SvObsG0(UnivariatePotential):
    """log N(y_0; 0, diag(exp(x))) (no nan_to_num, as in the JAX package)."""
    y0: torch.Tensor

    def __call__(self, x):
        return _norm_logpdf(self.y0, 0.0, torch.exp(0.5 * x)).sum(-1)


@dataclass(frozen=True)
class SvObsGt(Potential):
    """log N(y_t; 0, diag(exp(x_{t+1}))); params = ys[1:]."""
    prev_dependent = False

    def __call__(self, x_next, x_t, y):
        return _norm_logpdf(_rows(y, x_next), 0.0, torch.exp(0.5 * x_next)).sum(-1)


def get_feynman_kac(ys, nu, phi, tau, rho, chains=False):
    """The model through the cSMC interface: (M0, G0, Mt, Gt). With
    `chains`, for C chains on a leading axis: the per-step params, which
    every chain shares, carry a unit chain axis ((1, T-1, ...);
    `csmc_base.shared_by_chains`)."""
    T = ys.shape[0]
    m0, chol_P0, F, _, chol_Q, b = _factored_dynamics(nu, phi, tau, rho, ys)
    Mt = SvTransition(params=ys.new_zeros(T - 1, 0), F=F, b=b, chol_Q=chol_Q)
    Gt = SvObsGt(params=ys[1:])
    if chains:
        Mt, Gt = shared_by_chains(Mt), shared_by_chains(Gt)
    return SvPrior(m0, chol_P0), SvObsG0(ys[0]), Mt, Gt


def get_csmc_kernel(ys, nu, phi, tau, rho, n_particles, backward=False, parallel=False,
                    gradient=False, resampling="multinomial", chains=False):
    """Auxiliary PG with independent proposals (style `csmc`); returns
    (init, kernel), `kernel(state, delta, generator=None, noise=None)`. With
    `chains`, C chains as one batched step over a leading chain axis (x (C,
    T, D), delta (C, T), the noise with a leading C; `kernels/csmc.py`,
    `kernels/pit.py`); the kernel is marked `chain_axis`."""
    M0, G0, Mt, Gt = get_feynman_kac(ys, nu, phi, tau, rho, chains)
    return mark_chains(csmc_independent.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt, gradient=gradient,
        parallel=parallel, resampling=resampling), chains)


# --------------------------------------------------------------------------
# Guided cSMC (style csmc-guided): Kalman-gain recentred proposals
# --------------------------------------------------------------------------

def _obs_logpdf(x, y):
    return torch.nan_to_num(_norm_logpdf(_rows(y, x), 0.0, torch.exp(0.5 * x))).sum(-1)


def get_guided_csmc_kernel(ys, nu, phi, tau, rho, n_particles, backward=False, gradient=False,
                           resampling="multinomial", eig=None, chains=False):
    """Guided auxiliary PG: each proposal is the exact Gaussian combination
    of the prior step N(x_pred, Q) with the pseudo-observation u ~ N(x,
    delta/2). Returns (init, kernel); see `make_guided_factory` for `eig`.
    With `chains`, C chains as one batched step over a leading chain axis (x
    (C, T, D), delta (C, T), the noise with a leading C): one block-lane
    sweep and one backward factor sweep a step for all C chains; the kernel
    is marked `chain_axis`."""
    factory, Pt = make_guided_factory(ys, nu, phi, tau, rho, gradient, eig=eig, chains=chains)
    return mark_chains(csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling),
                       chains)


@dataclass(frozen=True)
class _GuidedConsts:
    """Constants of the guided proposal in Q's eigenbasis (z = VQ^T x)."""
    m0: torch.Tensor
    lam0: torch.Tensor
    V0: torch.Tensor
    FR: torch.Tensor        # F^T VQ
    bR: torch.Tensor        # b VQ
    VQ: torch.Tensor
    isl: torch.Tensor       # lamQ^{-1/2}
    half_logdet_Q: float
    half_d_log2pi: float
    gradient: bool
    packed: torch.Tensor    # [FRT, VQ, VQT, bR, isl, half_logdet_Q] for the CUDA functor


def _eigen_factors(lam, scale):
    """(gain, sqrt(Lam), 1/sqrt(Lam), 0.5 log det Lam) eigenvalues of the
    guided proposal at scale(s) `scale`; (..., 1) scales broadcast against
    (d,)."""
    s2 = scale ** 2
    g = lam / (lam + s2)
    lamL = lam * s2 / (lam + s2)
    sqrtL = torch.sqrt(lamL)
    return g, sqrtL, 1.0 / sqrtL, 0.5 * torch.log(lamL).sum(-1)


def _shifted(c, u, scale, y):
    """u + scale^2 grad_u log p(y | u) when the kernel is gradient-shifted
    (the model is separable, so one gradient of the sum serves every step)."""
    if not c.gradient:
        return u
    with torch.enable_grad():
        v = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_obs_logpdf(v, y).sum(), v)
    return u + scale[..., None] ** 2 * g


def _mat(x, A):
    """x (..., d) @ A (d, e), the d products summed elementwise in a fixed
    order: the same bits whatever x's leading shape (a BLAS product's
    rounding can change with its row count), so a batch of chains' step
    gives each chain one chain's bits."""
    return (x[..., :, None] * A).sum(-2)


def _initial_params(x, u, scale):
    """The t = 0 params u (..., d) and scale (...) aligned with particles x
    (..., N, d)."""
    if x.dim() > u.dim():
        return u.unsqueeze(-2), scale[..., None, None]
    return u, scale


@dataclass(frozen=True)
class GuidedM0(Distribution):
    """The guided proposal at t = 0; u (..., d) and scale (...), each chain's
    under a chain axis."""
    c: _GuidedConsts
    u: torch.Tensor
    scale: torch.Tensor
    y: torch.Tensor

    def _moments(self, x):
        c = self.c
        g, sqrtL, inv_sqrtL, hld = _eigen_factors(c.lam0, self.scale[..., None])
        resid = _shifted(c, self.u, self.scale, self.y) - c.m0
        mu = c.m0 + _mat(_mat(resid, c.V0) * g, c.V0.T)
        if x.dim() > mu.dim():  # particles (..., N, d)
            mu, sqrtL, inv_sqrtL = mu.unsqueeze(-2), sqrtL.unsqueeze(-2), inv_sqrtL.unsqueeze(-2)
            hld = hld[..., None]
        return mu, sqrtL, inv_sqrtL, hld

    def sample_from_noise(self, eps):
        mu, sqrtL, _, _ = self._moments(eps)
        return mu + _mat(_mat(eps, self.c.V0) * sqrtL, self.c.V0.T)

    def logpdf(self, x):
        mu, _, inv_sqrtL, hld = self._moments(x)
        w = _mat(x - mu, self.c.V0) * inv_sqrtL
        return -0.5 * (w * w).sum(-1) - hld - self.c.half_d_log2pi


@dataclass(frozen=True)
class GuidedG0(UnivariatePotential):
    c: _GuidedConsts
    u: torch.Tensor
    scale: torch.Tensor
    y: torch.Tensor

    def __call__(self, x):
        c = self.c
        u, scale = _initial_params(x, self.u, self.scale)
        w0 = _mat(x - c.m0, c.V0) / torch.sqrt(c.lam0)
        out = _obs_logpdf(x, self.y)
        out = out + (-0.5 * (w0 * w0).sum(-1) - 0.5 * torch.log(c.lam0).sum() - c.half_d_log2pi)
        out = out + _norm_logpdf(x, u, scale).sum(-1)
        return out - GuidedM0(c, self.u, self.scale, self.y).logpdf(x)


def _step_params(params, x):
    """The guided per-step params aligned with particles (..., N, d)."""
    u, scale, y, rotS, g, sqrtL, inv_sqrtL, hld = params
    if x.dim() > u.dim():
        u, y, rotS, g, sqrtL, inv_sqrtL = (p.unsqueeze(-2)
                                           for p in (u, y, rotS, g, sqrtL, inv_sqrtL))
        scale, hld = scale[..., None, None], hld[..., None]
    return u, scale, y, rotS, g, sqrtL, inv_sqrtL, hld


def _block_params(params):
    """The guided per-step params aligned with (..., d, N) particle blocks."""
    u, scale, y, rotS, g, sqrtL, inv_sqrtL, hld = params
    u, y, rotS, g, sqrtL, inv_sqrtL = (p[..., None] for p in (u, y, rotS, g, sqrtL, inv_sqrtL))
    return u, scale[..., None, None], y, rotS, g, sqrtL, inv_sqrtL, hld[..., None]


@dataclass(frozen=True, kw_only=True)
class GuidedMt(Dynamics):
    """The guided proposal; params = (u, scale, y, rotS, g, sqrtL,
    inv_sqrtL, hld) of steps 1..T-1."""
    c: _GuidedConsts
    cuda_model = "sv_guided"

    def sample_from_noise(self, eps, x_t, params):
        _, _, _, rotS, g, sqrtL, _, _ = _step_params(params, x_t)
        zp = x_t @ self.c.FR + self.c.bR
        zn = zp + g * (rotS - zp) + sqrtL * eps
        return zn @ self.c.VQ.T

    def block_propagate(self, eps, x_prev, params):
        """sample_from_noise on (..., d, N) blocks."""
        _, _, _, rotS, g, sqrtL, _, _ = _block_params(params)
        zp = self.c.FR.T @ x_prev + self.c.bR[:, None]
        zn = zp + g * (rotS - zp) + sqrtL * eps
        return self.c.VQ @ zn


@dataclass(frozen=True, kw_only=True)
class GuidedGt(Potential):
    """The guided weight: obs + N(x'; x_pred, Q) + N(x'; u, s) - N(x'; mu, Lam)."""
    c: _GuidedConsts
    cuda_model = "sv_guided"

    def __call__(self, x_next, x_t, params):
        c = self.c
        u, scale, y, rotS, g, _, inv_sqrtL, hld = _step_params(params, x_t)
        zp = x_t @ c.FR + c.bR
        zn = x_next @ c.VQ
        zmu = zp + g * (rotS - zp)
        out = _obs_logpdf(x_next, y)
        wq = (zn - zp) * c.isl
        out = out + (-0.5 * (wq * wq).sum(-1) - c.half_logdet_Q - c.half_d_log2pi)
        out = out + _norm_logpdf(x_next, u, scale).sum(-1)
        wl = (zn - zmu) * inv_sqrtL
        return out - (-0.5 * (wl * wl).sum(-1) - hld - c.half_d_log2pi)

    def block_logw(self, x_next, x_prev, params):
        """__call__ on (..., d, N) blocks; returns (..., N)."""
        c = self.c
        u, scale, y, rotS, g, _, inv_sqrtL, hld = _block_params(params)
        zp = c.FR.T @ x_prev + c.bR[:, None]
        zn = c.VQ.T @ x_next
        zmu = zp + g * (rotS - zp)
        obs = torch.nan_to_num(_norm_logpdf(y, 0.0, torch.exp(0.5 * x_next))).sum(-2)
        wq = (zn - zp) * c.isl[:, None]
        out = obs - 0.5 * (wq * wq).sum(-2) - c.half_logdet_Q - c.half_d_log2pi
        out = out + _norm_logpdf(x_next, u, scale).sum(-2)
        wl = (zn - zmu) * inv_sqrtL
        return out - (-0.5 * (wl * wl).sum(-2) - hld - c.half_d_log2pi)

    def cuda_operands(self):
        """(constants, per-step params) of the `sv_guided` CUDA functor:
        the packed constants and the (T-1, 6 d + 2) rows [u, y, rotS, g,
        sqrtL, inv_sqrtL, scale, hld]."""
        u, scale, y, rotS, g, sqrtL, inv_sqrtL, hld = self.params
        rows = torch.cat([u, y, rotS, g, sqrtL, inv_sqrtL, scale[..., None], hld[..., None]], -1)
        return self.c.packed, rows


def make_guided_factory(ys, nu, phi, tau, rho, gradient=False, eig=None, chains=False):
    """(factory, Pt) of the guided style.

    Every per-step quantity is a function of Q that commutes with Q, so in
    Q's eigenbasis the gain and the proposal covariance are elementwise
    eigenvalue transforms, and the proposal noise is consumed as eigenbasis
    noise. `eig = (lamQ, VQ, lam0, V0)` sets that basis (by default
    `torch.linalg.eigh` in float64 on the CPU). Q has a (d-1)-fold
    eigenvalue, so the basis inside that eigenspace is not unique: the law
    is the same in any basis, but reproducing another implementation's
    draws from the same noise needs its basis. With `chains`, `Pt` is the
    one of C chains (its params with a unit chain axis).
    """
    T, d = ys.shape
    m0, P0, F, Q, b = get_dynamics(nu, phi, tau, rho, d, device="cpu")
    _, _, Pt, _ = get_feynman_kac(ys, nu, phi, tau, rho, chains)
    if eig is None:
        lamQ, VQ = torch.linalg.eigh(Q)
        lam0, V0 = torch.linalg.eigh(P0)
    else:
        lamQ, VQ, lam0, V0 = (torch.as_tensor(z, dtype=torch.float64) for z in eig)
    FR, bR = F.T @ VQ, b @ VQ
    isl = 1.0 / torch.sqrt(lamQ)
    half_logdet_Q = float(0.5 * torch.log(lamQ).sum())
    packed = torch.cat([FR.T.reshape(-1), VQ.reshape(-1), VQ.T.reshape(-1), bR, isl,
                        torch.tensor([half_logdet_Q], dtype=torch.float64)])
    c = _GuidedConsts(*_cast(ys, m0, lam0, V0, FR, bR, VQ, isl), half_logdet_Q=half_logdet_Q,
                      half_d_log2pi=0.5 * d * _LOG_2PI, gradient=gradient,
                      packed=_cast(ys, packed)[0])
    lamQ = _cast(ys, lamQ)[0]

    def factory(u, scale):
        """The components at u (..., T, d), scale (..., T): one chain, or C
        chains' on a leading axis (their params (C, T-1, ...), the data
        broadcast to every chain, not copied; the constants shared)."""
        u_r, scale_r = u[..., 1:, :], scale[..., 1:]
        y = ys[1:].expand(u_r.shape)
        g, sqrtL, inv_sqrtL, hld = _eigen_factors(lamQ, scale_r[..., None])
        rotS = _mat(_shifted(c, u_r, scale_r, y), c.VQ)
        params = (u_r, scale_r, y, rotS, g, sqrtL, inv_sqrtL, hld)
        u0, s0 = u[..., 0, :], scale[..., 0]
        return (GuidedM0(c, u0, s0, ys[0]), GuidedG0(c, u0, s0, ys[0]),
                GuidedMt(params=params, c=c), GuidedGt(params=params, c=c))

    return factory, Pt
