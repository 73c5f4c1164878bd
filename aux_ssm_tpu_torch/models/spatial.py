"""Spatio-temporal model: d^2 independent 1-D random walks observed through a
multivariate Student-t with banded spatial precision (counterpart of
`aux_ssm_tpu/models/spatial.py`).

Model:  x_t in R^B, B = d^2,  x_0 ~ N(0, sigma_x^2 I),
        x_{t+1} = x_t + sigma_x eps  (independent per component)
        y_t ~ t_nu(x_t, P^{-1}) with P the banded precision of the d x d grid.

Sampler styles:
    kalman-1/2    auxiliary Kalman MH (`get_kalman_kernel`, order 1 or 2) in the
                  batched scalar LGSSM layout (T, B, 1, 1): B independent
                  scalar filters, the scans through `ops/cuda/scalar_scan`
    csmc          auxiliary PG with independent proposals (`get_csmc_kernel`),
                  the factor sweeps, or with `parallel=True` (the default of
                  `experiments/cli.py`) the PIT cSMC through the stitching kernels
    csmc-guided   scalar-gain guided auxiliary PG (`get_guided_csmc_kernel`),
                  the block-lane sweep with the functor `SpatialGuided`
sigma_x, nu, tau, r_y are Python floats; trajectories and data are (T, B)
tensors, and every tensor a kernel builds lies where `ys` lies. The precision
is applied as a convolution stencil (`t_distribution`), or as the dense
matrix in the (B, N)-block forms of the guided sweep. The gradient of the
potential is its closed form (nu + B) P (y - x) / (nu + (y-x)^T P (y-x)).
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import t_distribution as tdist
from ..device import resolve
from ..kernels import csmc_aux, csmc_independent
from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 diag_gaussian_pair_factors, mark_chains, rows as _rows,
                                 shared_by_chains)
from ..kernels.kalman import (chain_delta, chain_major, get_kernel as get_kalman_generic,
                              one_chain)
from ..native.precision import make_precision_dense, precision_rows, precision_stencil
from ..ops.mvn import norm_logpdf
from ..ops.resampling import choice_from_uniform


def get_dynamics(sigma_x, d, *, dtype=torch.float64, device=None):
    """Batched scalar dynamics (m0, P0, F, Q, b) of B = d^2 independent random
    walks: m0, b (B, 1); P0, F, Q (B, 1, 1)."""
    kw = dict(dtype=dtype, device=resolve(device))
    B = d * d
    F = torch.ones(B, 1, 1, **kw)
    Q = sigma_x ** 2 * torch.ones(B, 1, 1, **kw)
    b = torch.zeros(B, 1, **kw)
    return b, Q, F, Q, b  # m0 = 0, P0 = Q


def get_data(rng, sigma_x, r_y, tau, nu, d, T, *, dtype=torch.float64, device=None):
    """Simulate (xs, ys), each (T, B): a random-walk field and Student-t noise,
    from the NumPy generator `rng` in float64 on the CPU (the JAX package's
    own simulation, draw for draw); the result is moved to `device`."""
    device = resolve(device)
    B = d * d
    chol_cov = np.linalg.cholesky(np.linalg.inv(make_precision_dense(tau, r_y, d)))
    xs = np.cumsum(sigma_x * rng.standard_normal((T, B)), axis=0)
    g = rng.standard_normal((T, B)) @ chol_cov.T
    u = rng.chisquare(nu, size=(T, 1)) / nu
    ys = xs + g / np.sqrt(u)
    return (torch.as_tensor(xs, dtype=dtype, device=device),
            torch.as_tensor(ys, dtype=dtype, device=device))


def _stencil(tau, r_y, like):
    return torch.as_tensor(precision_stencil(tau, r_y), dtype=like.dtype, device=like.device)


def log_potential_one(x, y, nu, stencil, d):
    """Per-time-step t potential; batched over leading axes of x."""
    return torch.nan_to_num(tdist.logpdf(y, x, nu, stencil=stencil, d=d))


def log_potential(xs, ys, nu, stencil, d):
    """sum_t log_potential_one(x_t, y_t)."""
    return log_potential_one(xs, ys, nu, stencil, d).sum()


def grad_log_potential_one(x, y, nu, stencil, d):
    """d/dx of the t potential at x, in closed form; batched over leading
    axes (x and y broadcast)."""
    x, y = torch.broadcast_tensors(x, y)
    diff = y - x
    Pd = tdist.apply_precision_stencil(diff, stencil, d)
    q = (diff * Pd).sum(-1, keepdim=True)
    return (nu + x.shape[-1]) * Pd / (nu + q)


def init_x_fn(ys, sigma_x, nu, stencil, d, N, generator=None):
    """Initial trajectory (T, B): a bootstrap particle filter with systematic
    resampling, then one backward-sampled trajectory (the JAX package's
    `init_x_fn`, in law: the draws come from `generator`)."""
    T, B = ys.shape
    kw = dict(generator=generator, dtype=ys.dtype, device=ys.device)
    eps = torch.randn(T + 1, N, B, **kw)
    u_sys, u_back = torch.rand(T, **kw), torch.rand(T, **kw)
    grid0 = torch.arange(N, dtype=ys.dtype, device=ys.device)

    x = sigma_x * eps[0]
    xs, log_ws = [], []
    for t in range(T):
        log_w = log_potential_one(x, ys[t], nu, stencil, d)
        log_w = log_w - torch.logsumexp(log_w, 0)
        anc = torch.searchsorted(torch.cumsum(torch.exp(log_w), 0), (u_sys[t] + grid0) / N)
        xs.append(x)
        log_ws.append(log_w)
        x = x[anc.clamp_(max=N - 1)] + sigma_x * eps[t + 1]

    x_next = xs[-1][choice_from_uniform(u_back[-1], torch.exp(log_ws[-1]))][0]
    traj = [x_next]
    for t in range(T - 2, -1, -1):
        lw = log_ws[t] + norm_logpdf(x_next, xs[t], sigma_x).sum(-1)
        w = torch.exp(lw - torch.logsumexp(lw, 0))
        x_next = xs[t][choice_from_uniform(u_back[t], w)][0]
        traj.append(x_next)
    return torch.stack(traj[::-1])


# --------------------------------------------------------------------------
# Auxiliary Kalman (batched scalar filters)
# --------------------------------------------------------------------------

def get_kalman_kernel(ys, sigma_x, nu, tau, r_y, d, parallel, order=1, chains=False):
    """Auxiliary Kalman kernel in the batched (T, B, 1, 1) layout; `order` 2
    uses the diagonal approximation hess ~ -nu diag(P) / (nu - 2), and the
    stencil's centre is 1. Returns (init, kernel) of `kernels.kalman
    .get_kernel`; `init` takes a (T, B) or (T, B, 1) trajectory.

    With `chains`, C chains as one batched step over a leading chain axis:
    `init(x (C, T, B) or (C, T, B, 1))`, the state's x (C, T, B, 1), delta
    (C,), noise ((C, T, B, 1), (C, T, B, 1), (C,)); inside, the chains' B
    components are C B columns of the batched scalar layout (`kernels.kalman
    .get_kernel`'s `group`), so a step launches the scalar scans as often as
    one chain's does, and each chain's densities are summed over its own B
    columns: one accept a chain. The kernel is marked `chain_axis`. Without
    `chains`, one chain's: the same kernel at C = 1 (`kernels.kalman
    .one_chain`), x (T, B, 1), a scalar delta and `updated`."""
    T, B = ys.shape
    if B != d * d:
        raise ValueError(f"ys has {B} components, expected d * d = {d * d}")
    stencil = _stencil(tau, r_y, ys)
    kw = dict(dtype=ys.dtype, device=ys.device)
    m0, P0, F, Q, b = get_dynamics(sigma_x, d, **kw)
    hess_diag = -nu / (nu - 2.0)
    columns = {}  # C -> the layout's constant parts at C B columns

    def layout(x):
        C = x.shape[1] // B
        if C not in columns:
            columns[C] = (m0.repeat(C, 1), P0.repeat(C, 1, 1),
                          F.repeat(C, 1, 1).expand(T - 1, C * B, 1, 1),
                          Q.repeat(C, 1, 1).expand(T - 1, C * B, 1, 1),
                          b.repeat(C, 1).expand(T - 1, C * B, 1),
                          torch.ones(T, C * B, 1, 1, **kw), torch.zeros(T, C * B, 1, **kw))
        return C, columns[C]

    def chain_view(x):
        """(T, C B, 1) columns as (T, C, B) chains."""
        return x[..., 0].unflatten(1, (-1, B))

    def dynamics_factory(x):
        return layout(x)[1][:5]

    def grad(x):
        g = grad_log_potential_one(chain_view(x), ys[:, None], nu, stencil, d)
        return torch.nan_to_num(g).flatten(1)[..., None]

    def first_order_factory(x, u, delta):
        eyes, zeros = layout(x)[1][5:]
        half = 0.5 * chain_delta(delta, B)
        aux_ys = u + half * grad(x)
        return aux_ys, eyes, half[..., None] * eyes, zeros

    def second_order_factory(x, u, delta):
        eyes, zeros = layout(x)[1][5:]
        dl = chain_delta(delta, B)
        omega = 1.0 / (2.0 / dl - hess_diag)
        aux_ys = omega * (2.0 * u / dl + grad(x) - hess_diag * x)
        return aux_ys, eyes, omega[..., None] * eyes, zeros

    def log_likelihood_fn(x):
        flat = chain_view(x)
        out = norm_logpdf(flat[0], 0.0, sigma_x).sum(-1)
        out = out + norm_logpdf(flat[1:], flat[:-1], sigma_x).sum(0).sum(-1)
        return out + log_potential_one(flat, ys[:, None], nu, stencil, d).sum(0)

    factory = first_order_factory if order == 1 else second_order_factory
    init_, kernel = chain_major(*get_kalman_generic(dynamics_factory, factory,
                                                    log_likelihood_fn, parallel, chains=True,
                                                    group=B), group=B)

    def init(xs):
        return init_(xs[..., None] if xs.dim() == 3 else xs)

    return (init, kernel) if chains else one_chain(init, kernel)


# --------------------------------------------------------------------------
# Feynman–Kac components (cSMC styles); broadcast convention of `csmc_base`
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SpatialPrior(Distribution, UnivariatePotential):
    """x_0 ~ N(0, sigma_x^2 I); also its own log-density potential."""
    sigma_x: float

    def sample_from_noise(self, eps):
        return self.sigma_x * eps

    def logpdf(self, x):
        return norm_logpdf(x, 0.0, self.sigma_x).sum(-1)

    def __call__(self, x):
        return self.logpdf(x)


@dataclass(frozen=True, kw_only=True)
class SpatialTransition(Dynamics):
    """x_{t+1} ~ N(x_t, sigma_x^2 I); params unused (T-1, 0)."""
    sigma_x: float

    def sample_from_noise(self, eps, x_t, params):
        return x_t + self.sigma_x * eps

    def logpdf(self, x_next, x_t, params):
        return norm_logpdf(x_next, x_t, self.sigma_x).sum(-1)

    def logpdf_factors(self, x_prev, x_next, params):
        return diag_gaussian_pair_factors(x_prev, x_next, self.sigma_x)


@dataclass(frozen=True)
class SpatialObsG0(UnivariatePotential):
    y0: torch.Tensor
    nu: float
    stencil: torch.Tensor
    d: int

    def __call__(self, x):
        return log_potential_one(x, self.y0, self.nu, self.stencil, self.d)


@dataclass(frozen=True, kw_only=True)
class SpatialObsGt(Potential):
    """The t potential of y_{t+1} at x_{t+1}; params = ys[1:]."""
    nu: float
    stencil: torch.Tensor
    d: int
    prev_dependent = False

    def __call__(self, x_next, x_t, y):
        return log_potential_one(x_next, _rows(y, x_next), self.nu, self.stencil, self.d)


def get_feynman_kac(ys, sigma_x, nu, tau, r_y, d, chains=False):
    """The model through the cSMC interface: (M0, G0, Mt, Gt). With
    `chains`, for C chains on a leading axis: the per-step params, which
    every chain shares, carry a unit chain axis ((1, T-1, ...);
    `csmc_base.shared_by_chains`)."""
    T = ys.shape[0]
    stencil = _stencil(tau, r_y, ys)
    Mt = SpatialTransition(params=ys.new_zeros(T - 1, 0), sigma_x=sigma_x)
    Gt = SpatialObsGt(params=ys[1:], nu=nu, stencil=stencil, d=d)
    if chains:
        Mt, Gt = shared_by_chains(Mt), shared_by_chains(Gt)
    return SpatialPrior(sigma_x), SpatialObsG0(ys[0], nu, stencil, d), Mt, Gt


def get_csmc_kernel(ys, sigma_x, nu, tau, r_y, d, n_particles, backward=False, parallel=False,
                    gradient=False, resampling="multinomial", chains=False):
    """Auxiliary PG with independent proposals (style `csmc`); returns
    (init, kernel), `kernel(state, delta, generator=None, noise=None)`. With
    `chains`, C chains as one batched step over a leading chain axis (x (C,
    T, B), delta (C, T), the noise with a leading C); the kernel is marked
    `chain_axis`."""
    M0, G0, Mt, Gt = get_feynman_kac(ys, sigma_x, nu, tau, r_y, d, chains)
    return mark_chains(csmc_independent.get_kernel(
        M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt, gradient=gradient,
        parallel=parallel, resampling=resampling), chains)


# --------------------------------------------------------------------------
# Guided cSMC (style csmc-guided): scalar-gain recentred proposals
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class _GuidedConsts:
    sigma_x: float
    nu: float
    d: int
    gradient: bool
    stencil: torch.Tensor
    prec: torch.Tensor      # dense (B, B) precision, for the (B, N)-block forms
    packed: torch.Tensor    # [sigma_x, nu, gradient, W, P's row lists] for the CUDA functor
    ell_width: int          # W, the most nonzeros in a row of the precision

    def moments(self, x_pred, u, scale, y):
        """Mean and scale of the proposal: N(x_pred, sigma_x^2) combined with
        u ~ N(x, scale^2), the auxiliary observation shifted along the
        potential's gradient at x_pred when the kernel is gradient-shifted.
        u, scale, y are aligned with x_pred (`_aligned`)."""
        s2 = self.sigma_x ** 2
        K = s2 / (s2 + scale ** 2)
        lam = torch.sqrt(s2 * (1.0 - K))
        if self.gradient:
            u = u + scale ** 2 * grad_log_potential_one(x_pred, y, self.nu, self.stencil, self.d)
        return x_pred + K * (u - x_pred), lam

    def block_moments(self, x_prev, u, scale, y):
        """`moments` on (..., B, N) blocks with the dense precision."""
        u, y, scale = u[..., None], y[..., None], scale[..., None, None]
        s2 = self.sigma_x ** 2
        K = s2 / (s2 + scale ** 2)
        lam = torch.sqrt(s2 * (1.0 - K))
        if self.gradient:
            diff = y - x_prev
            Pv = self.prec @ diff
            q = (diff * Pv).sum(-2, keepdim=True)
            u = u + scale ** 2 * (self.nu + self.d * self.d) * Pv / (self.nu + q)
        return x_prev + K * (u - x_prev), lam

    def guided_logw(self, x, x_pred, params):
        """t potential + N(x; x_pred, sigma_x) + N(x; u, scale) - proposal."""
        u, scale, y = _aligned(x, *params)
        mu, lam = self.moments(x_pred, u, scale, y)
        out = log_potential_one(x, y, self.nu, self.stencil, self.d)
        out = out + norm_logpdf(x, x_pred, self.sigma_x).sum(-1)
        out = out + norm_logpdf(x, u, scale).sum(-1)
        return out - norm_logpdf(x, mu, lam).sum(-1)


def _aligned(x, u, scale, y):
    """The per-step params u, y (..., B) and scale (...) aligned with
    particles x (..., N, B)."""
    if x.dim() > u.dim():
        return u.unsqueeze(-2), scale[..., None, None], y.unsqueeze(-2)
    return u, scale, y


@dataclass(frozen=True)
class GuidedM0(Distribution):
    """The guided proposal at t = 0 (x_pred = 0); u (..., B) and scale (...),
    each chain's under a chain axis."""
    c: _GuidedConsts
    u: torch.Tensor
    scale: torch.Tensor
    y: torch.Tensor

    def sample_from_noise(self, eps):
        u, scale, y = _aligned(eps, self.u, self.scale, self.y)
        mu, lam = self.c.moments(torch.zeros_like(u), u, scale, y)
        return mu + lam * eps


@dataclass(frozen=True)
class GuidedG0(UnivariatePotential):
    c: _GuidedConsts
    u: torch.Tensor
    scale: torch.Tensor
    y: torch.Tensor

    def __call__(self, x):
        u = _aligned(x, self.u, self.scale, self.y)[0]
        return self.c.guided_logw(x, torch.zeros_like(u), (self.u, self.scale, self.y))


@dataclass(frozen=True, kw_only=True)
class GuidedMt(Dynamics):
    """The guided proposal; params = (u, scale, y) of steps 1..T-1."""
    c: _GuidedConsts
    cuda_model = "spatial_guided"

    def sample_from_noise(self, eps, x_t, params):
        mu, lam = self.c.moments(x_t, *_aligned(x_t, *params))
        return mu + lam * eps

    def block_propagate(self, eps, x_prev, params):
        """sample_from_noise on (..., B, N) blocks."""
        mu, lam = self.c.block_moments(x_prev, *params)
        return mu + lam * eps


@dataclass(frozen=True, kw_only=True)
class GuidedGt(Potential):
    """The guided weight: t potential + N(x'; x, sigma_x) + N(x'; u, s) -
    N(x'; mu, lam); params as GuidedMt's."""
    c: _GuidedConsts
    cuda_model = "spatial_guided"

    def __call__(self, x_next, x_t, params):
        return self.c.guided_logw(x_next, x_t, params)

    def block_logw(self, x_next, x_prev, params):
        """__call__ on (..., B, N) blocks; returns (..., N)."""
        c = self.c
        u, scale, y = params
        mu, lam = c.block_moments(x_prev, u, scale, y)
        diff = y[..., None] - x_next
        q = (diff * (c.prec @ diff)).sum(-2)
        out = torch.nan_to_num(-0.5 * (c.nu + c.d * c.d) * torch.log1p(q / c.nu))
        out = out + norm_logpdf(x_next, x_prev, c.sigma_x).sum(-2)
        out = out + norm_logpdf(x_next, u[..., None], scale[..., None, None]).sum(-2)
        return out - norm_logpdf(x_next, mu, lam).sum(-2)

    @property
    def ell_width(self):
        """W of the functor's row lists of the precision (`cuda_operands`)."""
        return self.c.ell_width

    def cuda_operands(self):
        """(constants, per-step rows) of the `spatial_guided` CUDA functor:
        the packed constants [sigma_x, nu, gradient, W, values (B, W),
        columns (B, W)] (the precision's row lists) and the (T-1, 2 B + 7)
        rows [u, y, scale, K, lam, scale^2 (nu + B), B (log 2 pi sigma_x^2
        + log 2 pi scale^2 - log 2 pi lam^2), 1 / scale^2, 1 / lam^2]: the
        step's constants, taken here once a step."""
        u, scale, y = self.params
        c = self.c
        B = c.d * c.d
        s2, sc2 = c.sigma_x ** 2, scale * scale
        K = s2 / (s2 + sc2)
        lam = torch.sqrt(s2 * (1.0 - K))
        lam2 = lam * lam
        log_c = B * (math.log(2 * math.pi * s2) + torch.log(2 * math.pi * sc2)
                     - torch.log(2 * math.pi * lam2))
        step = torch.stack([scale, K, lam, sc2 * (c.nu + B), log_c, 1.0 / sc2, 1.0 / lam2], -1)
        return c.packed, torch.cat([u, y, step], -1)


def make_guided_factory(ys, sigma_x, nu, tau, r_y, d, gradient=False, chains=False):
    """`factory(u, scale) -> (M0, G0, Mt, Gt)` of the guided proposals at
    auxiliary observations u (T, B) with scales (T,), or C chains' u (C, T,
    B) and scales (C, T) (their params (C, T-1, ...), the data broadcast to
    every chain, not copied; the precision's row lists shared), and the true
    dynamics `Pt` for backward sampling (with `chains`, C chains': its params
    with a unit chain axis)."""
    _, _, Pt, _ = get_feynman_kac(ys, sigma_x, nu, tau, r_y, d, chains)
    prec = make_precision_dense(tau, r_y, d)
    vals, cols = precision_rows(prec)
    packed = np.concatenate([[sigma_x, nu, float(gradient), vals.shape[1]], vals.reshape(-1),
                             cols.reshape(-1)])
    c = _GuidedConsts(sigma_x, nu, d, gradient, _stencil(tau, r_y, ys),
                      torch.as_tensor(prec, dtype=ys.dtype, device=ys.device),
                      torch.as_tensor(packed, dtype=ys.dtype, device=ys.device), vals.shape[1])

    def factory(u, scale):
        u_r = u[..., 1:, :]
        params = (u_r, scale[..., 1:], ys[1:].expand(u_r.shape))
        u0, s0 = u[..., 0, :], scale[..., 0]
        return (GuidedM0(c, u0, s0, ys[0]), GuidedG0(c, u0, s0, ys[0]),
                GuidedMt(params=params, c=c), GuidedGt(params=params, c=c))

    return factory, Pt


def get_guided_csmc_kernel(ys, sigma_x, nu, tau, r_y, d, n_particles, backward=False,
                           gradient=False, resampling="multinomial", chains=False):
    """Scalar-gain guided proposals: K = sigma_x^2 / (sigma_x^2 + delta / 2)
    recentres the random walk on the (optionally gradient-shifted) auxiliary
    observation. Returns (init, kernel), `kernel(state, delta, generator=None,
    noise=None)`. With `chains`, C chains as one batched step over a leading
    chain axis (x (C, T, B), delta (C, T), the noise with a leading C): one
    block-lane sweep and one backward factor sweep a step for all C chains;
    the kernel is marked `chain_axis`."""
    factory, Pt = make_guided_factory(ys, sigma_x, nu, tau, r_y, d, gradient, chains)
    return mark_chains(csmc_aux.get_kernel(factory, n_particles, backward, Pt, resampling),
                       chains)
