"""Stochastic Lorenz-63 model with partial observations and conjugate
parameter learning (counterpart of `aux_ssm_tpu/models/lorenz.py`).

Model: Euler-Maruyama discretisation of
    dX = (phi_0(X) + theta .* phi(X)) dt + sigma_x dW,   X in R^3,
with theta entering linearly, so theta given a trajectory has a conjugate
Gaussian (diagonal Bayesian linear regression) law. Observations: (x2, x3)
on a grid of steps through N(., sig_y^2 I); `ys` and `Hs` are NaN on every
other step, and the masked Kalman machinery drops those rows exactly.

The proposal LGSSM linearises the drift at the current trajectory with
`extended`, all T - 1 steps in one `torch.func.vmap` call, and stacks the
auxiliary u rows on the data rows: dx = 3, dy = 3 + 2 (the MH kernels' D = 16
instance on the card). The Gibbs step rebuilds the Kalman kernel at each new
theta; what does not depend on theta (the target's whiteners, the stacked
observation model's constant parts) is computed once per `get_gibbs_kernel`.

C chains (`get_gibbs_kernel(..., chains=True)`) take one batched step: each
chain has its own theta (C, 3), so its own linearised F and b (the dense
batched layout of `ops/lgssm.py`, time first inside); Q, H, c, m0, P0 and the
whiteners are every chain's, made once; u and R (delta / 2 on the u rows)
are each chain's.

Tensor arguments fix the dtype and device; functions that build tensors from
numbers take `dtype` and `device` (None: the card, `device.default_device`).
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..kernels.kalman import (KalmanSampler, chain_delta, chain_major,
                              get_kernel as get_kalman_generic, one_chain_factories)
from ..ops import mvn
from ..ops.linearise import extended_steps

_LOG_2PI = math.log(2.0 * math.pi)


def phi_0(x):
    """The theta-free part of the drift, on (..., 3)."""
    x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([torch.zeros_like(x1), -x2 - x1 * x3, x1 * x2], dim=-1)


def phi(x):
    """The drift's factor of theta, on (..., 3)."""
    x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([x2 - x1, x1, -x3], dim=-1)


def get_dynamics(theta, sigma_x, dt):
    """The conditional mean callable mean(x, params) and the constant
    innovation covariance Q, on `theta`'s dtype and device. `params`, if
    not None, is the theta to use in place of `theta`."""
    def mean(x, params):
        th = theta if params is None else params
        return x + dt * (phi_0(x) + th * phi(x))

    Q = dt * sigma_x ** 2 * torch.eye(3, dtype=theta.dtype, device=theta.device)
    return mean, Q


def sample_trajectory(m0, P0, theta, sigma_x, dt, n_steps, *, generator=None, noise=None,
                      dtype=torch.float64, device=None):
    """Simulate x_{0:n_steps} (n_steps, 3) in float64 on the CPU and move it to
    `device` as `dtype`. `noise = (eps0 (3,), eps (n_steps - 1, 3))`, if
    given, replaces the normals drawn from `generator` (a CPU generator):
    x_0 = m0 + chol(P0) eps0, then x_{t+1} = mean(x_t) + sigma_x sqrt(dt) eps_t."""
    f64 = dict(dtype=torch.float64, device="cpu")
    m0, P0, theta = (torch.as_tensor(z, **f64) for z in (m0, P0, theta))
    if noise is None:
        noise = (torch.randn(3, generator=generator, **f64),
                 torch.randn(n_steps - 1, 3, generator=generator, **f64))
    eps0, eps = (torch.as_tensor(z, **f64) for z in noise)
    mean, _ = get_dynamics(theta, sigma_x, dt)
    x = m0 + torch.linalg.cholesky(P0) @ eps0
    xs = [x]
    for e in eps:
        x = mean(x, None) + sigma_x * math.sqrt(dt) * e
        xs.append(x)
    return torch.stack(xs).to(dtype=dtype, device=resolve(device))


def observations_model(data, sig_y, n_steps, sample_every=None, obs_idx=None):
    """NaN-padded observation grid, in NumPy: rows of ys and Hs are NaN except
    at the observation steps, every `sample_every` steps or the explicit
    `obs_idx` (one entry a data row, e.g. the Mider data at freq 8, whose
    0.01 / dt = 12.5 steps are rounded). Returns (ys (n, 2), Hs (n, 2, 3),
    Rs (n, 2, 2), cs (n, 2))."""
    ys = data[:, 1:]
    if obs_idx is None:
        obs_idx = np.arange(len(ys)) * sample_every
    obs_idx = np.asarray(obs_idx, dtype=np.int64)
    if len(obs_idx) != len(ys) or obs_idx[-1] >= n_steps:
        raise ValueError(f"observation indices ({len(obs_idx)} entries, max "
                         f"{obs_idx[-1]}) do not fit {len(ys)} data rows on "
                         f"a {n_steps}-step grid")
    ys_ext = np.full((n_steps, 2), np.nan)
    ys_ext[obs_idx] = ys

    H = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    Hs = np.full((n_steps, 2, 3), np.nan)
    Hs[obs_idx] = H

    Rs = np.tile(sig_y ** 2 * np.eye(2)[None], (n_steps, 1, 1))
    cs = np.zeros_like(ys_ext)
    return ys_ext, Hs, Rs, cs


def theta_posterior_mean_and_chol(x, sigma_theta, dt, sigma_x):
    """Mean and (diagonal) scale of theta given a trajectory x (T, 3), or
    given C chains' (T, C, 3) (then (C, 3) each): the drift is linear in
    theta, so this is a Bayesian linear regression."""
    Y = (x[1:] - x[:-1]) - dt * phi_0(x[:-1])
    X = dt * phi(x[:-1])
    sigma_Y = sigma_x * math.sqrt(dt)

    Sigma = 1.0 / ((X * X).sum(0) + 1.0 / sigma_theta ** 2)
    mean = Sigma * (X * Y).sum(0)
    return mean, sigma_Y * torch.sqrt(Sigma)


def init_x_fn(data, n_steps, *, dtype=torch.float32, device=None):
    """Initial trajectory (n_steps, 3): x1 = 25, x2 and x3 linearly
    interpolated from the data (t, y2, y3) on a uniform grid over [0, t_end].
    The interpolation runs in NumPy on the host."""
    data = np.asarray(data, dtype=np.float64)
    ts = np.linspace(0.0, data[-1, 0], n_steps)
    xs = np.ones((n_steps, 3))
    xs[:, 0] = 25.0
    xs[:, 1] = np.interp(ts, data[:, 0], data[:, -2])
    xs[:, 2] = np.interp(ts, data[:, 0], data[:, -1])
    return torch.as_tensor(xs, dtype=dtype, device=resolve(device))


def target_whiteners(m0, P0, Rs, sigma_x, dt):
    """The theta-free factorisations of the target density: chol(P0),
    chol(Q), chol(Rs)^{-1} (T, dy, dy) and the log-determinants of chol(Rs)
    (T,). Computed in float64 on the CPU, once, and cast to `Rs`' dtype and
    device."""
    cpu = dict(dtype=torch.float64, device="cpu")
    Q = dt * sigma_x ** 2 * torch.eye(3, **cpu)
    chol_Rs = torch.linalg.cholesky(Rs.to(**cpu))
    eye_y = torch.eye(Rs.shape[-1], **cpu).expand(chol_Rs.shape)
    out = {"chol_P0": torch.linalg.cholesky(P0.to(**cpu)), "chol_Q": torch.linalg.cholesky(Q),
           "inv_chol_Rs": torch.linalg.solve_triangular(chol_Rs, eye_y, upper=False),
           "logdet_Rs": torch.log(torch.diagonal(chol_Rs, dim1=-2, dim2=-1)).sum(-1)}
    return {k: v.to(dtype=Rs.dtype, device=Rs.device) for k, v in out.items()}


@dataclass(frozen=True)
class _Constants:
    """What a Lorenz Kalman kernel needs that theta does not change."""
    m0: torch.Tensor
    P0: torch.Tensor
    Qs: torch.Tensor         # (T-1, 3, 3), the innovation covariance at every step
    aux_Hs: torch.Tensor     # (T, 5, 3): I on the u rows, Hs on the data rows
    aux_cs: torch.Tensor     # (T, 5)
    ys: torch.Tensor         # (T, 2)
    Rs_block: torch.Tensor   # (T, 5, 5): Rs on the data block, zeros elsewhere
    u_diag: torch.Tensor     # (5, 5): ones on the u block's diagonal
    Hs_filled: torch.Tensor  # nan_to_num(Hs)
    ys_filled: torch.Tensor  # nan_to_num(ys)
    observed: torch.Tensor   # (T,) bool: the data rows are observed
    whiteners: dict
    sigma_x: float
    dt: float


def _constants(ys, Hs, Rs, cs, m0, P0, sigma_x, dt, whiteners=None):
    T, dy = ys.shape
    kw = dict(dtype=ys.dtype, device=ys.device)
    m0, P0 = torch.as_tensor(m0, **kw), torch.as_tensor(P0, **kw)
    eye = torch.eye(3, **kw)
    Rs_block = torch.zeros(T, 3 + dy, 3 + dy, **kw)
    Rs_block[:, 3:, 3:] = Rs
    u_diag = torch.zeros(3 + dy, 3 + dy, **kw)
    u_diag[:3, :3] = eye
    Q = dt * sigma_x ** 2 * eye
    return _Constants(
        m0=m0, P0=P0, Qs=Q.expand(T - 1, 3, 3).contiguous(),
        aux_Hs=torch.cat([eye.expand(T, 3, 3), Hs], dim=1),
        aux_cs=torch.cat([torch.zeros(T, 3, **kw), cs], dim=1),
        ys=ys, Rs_block=Rs_block, u_diag=u_diag,
        Hs_filled=torch.nan_to_num(Hs), ys_filled=torch.nan_to_num(ys),
        observed=torch.isfinite(ys[:, 0]),
        whiteners=(target_whiteners(m0, P0, Rs, sigma_x, dt) if whiteners is None
                   else whiteners),
        sigma_x=sigma_x, dt=dt)


def _factories(c, theta):
    """(dynamics_factory, observations_factory, log_likelihood_fn) at C
    chains' theta (C, 3) from the theta-free constants, on time-first
    trajectories (T, C, 3), delta (C,) or (C, T)."""
    mean, Q = get_dynamics(theta, c.sigma_x, c.dt)
    w = c.whiteners
    dy = c.ys.shape[-1]
    # A unit chain axis on what every chain shares.
    Qs, aux_Hs, aux_cs, observed = (z[:, None] for z in (c.Qs, c.aux_Hs, c.aux_cs, c.observed))

    def cov(_x, _params):
        return Q

    def dynamics_factory(x):
        Fs, _, bs = extended_steps(mean, cov, x[:-1], theta)
        return c.m0, c.P0, Fs, Qs, bs

    def observations_factory(_x, u, delta):
        # The block-diagonal diag(delta / 2 I, R_t) of every step at once:
        # exactly torch.block_diag's entries, which is not batched.
        aux_Rs = c.Rs_block[:, None] + (0.5 * chain_delta(delta))[..., None] * c.u_diag
        ys = c.ys[:, None].expand(u.shape[:2] + c.ys.shape[1:])
        return torch.cat([u, ys], dim=-1), aux_Hs, aux_Rs, aux_cs

    def log_likelihood_fn(x):
        out = mvn.logpdf(x[0], c.m0, w["chol_P0"])
        out = out + mvn.logpdf(x[1:], mean(x[:-1], None), w["chol_Q"]).sum(0)
        pred_y = (c.Hs_filled[:, None] @ x[..., None])[..., 0]
        diff = torch.where(observed[..., None], c.ys_filled[:, None] - pred_y, 0.0)
        wd = (w["inv_chol_Rs"][:, None] @ diff[..., None])[..., 0]
        step = -0.5 * (wd * wd).sum(-1) - w["logdet_Rs"][:, None] - 0.5 * dy * _LOG_2PI
        return out + torch.where(observed, step, 0.0).sum(0)

    return dynamics_factory, observations_factory, log_likelihood_fn


def get_kalman_factories(ys, Hs, Rs, cs, m0, P0, theta, sigma_x, dt, whiteners=None,
                         chains=False):
    """The auxiliary-Kalman pieces at a fixed theta: (dynamics_factory,
    observations_factory, log_likelihood_fn) for `kernels.kalman.get_kernel`.
    The drift is linearised at every step by `extended` and u is stacked on
    the data rows. `whiteners` (from `target_whiteners`) spares their
    factorisation. With `chains`, C chains' pieces at theta (C, 3), on
    time-first trajectories (T, C, 3) (the dense batched layout); without,
    one chain's at theta (3,): the same pieces at C = 1
    (`one_chain_factories`)."""
    theta = torch.as_tensor(theta, dtype=ys.dtype, device=ys.device)
    consts = _constants(ys, Hs, Rs, cs, m0, P0, sigma_x, dt, whiteners)
    if chains:
        return _factories(consts, theta)
    return one_chain_factories(*_factories(consts, theta[None]))


def get_kalman_kernel(ys, Hs, Rs, cs, m0, P0, theta, sigma_x, dt, parallel, whiteners=None):
    """Auxiliary Kalman kernel at a fixed theta (`get_kalman_factories`);
    returns (init, kernel) of `kernels.kalman.get_kernel`."""
    return get_kalman_generic(*get_kalman_factories(ys, Hs, Rs, cs, m0, P0, theta, sigma_x, dt,
                                                    whiteners), parallel)


@dataclass(frozen=True)
class GibbsState:
    """State of the Gibbs sampler: the Kalman sampler's state and theta."""
    kalman_state: KalmanSampler
    theta: torch.Tensor

    @property
    def x(self):
        return self.kalman_state.x

    @property
    def updated(self):
        return self.kalman_state.updated


def get_gibbs_kernel(ys, Hs, Rs, cs, m0, P0, sigma_x, dt, sigma_theta, parallel,
                     chains=False):
    """Gibbs sampler alternating the trajectory kernel at the current theta
    with the conjugate theta draw. Returns (init, kernel): `init(x, theta)`
    and `kernel(state, delta, generator=None, noise=None)`, `noise =
    (kalman_noise, eps_theta (3,))` with `kalman_noise` that of
    `kernels.kalman.get_kernel` (None: drawn from `generator`); theta' =
    mean + chol * eps_theta.

    With `chains`, C chains as one batched step over a leading chain axis:
    `init(x (C, T, 3), theta (C, 3))`, the state's x (C, T, 3), updated
    (C,) and theta (C, 3), delta (C,) or (C, T), `noise = ((eps_aux (C, T,
    3), eps_smooth (C, T, 3), u_accept (C,)), eps_theta (C, 3))`. The
    kernel is marked `chain_axis` (`experiments/cli.py`); each of the six
    MH kernels launches as often a step as for one chain."""
    consts = _constants(ys, Hs, Rs, cs, m0, P0, sigma_x, dt)

    def kernel(state, delta, generator=None, noise=None):
        kalman_noise, eps_theta = (None, None) if noise is None else noise
        if chains:
            kalman_kernel = chain_major(*get_kalman_generic(
                *_factories(consts, state.theta), parallel, chains=True))[1]
        else:
            kalman_kernel = get_kalman_generic(
                *one_chain_factories(*_factories(consts, state.theta[None])), parallel)[1]
        kalman_state = kalman_kernel(state.kalman_state, delta, generator=generator,
                                     noise=kalman_noise)
        x = kalman_state.x.transpose(0, 1) if chains else kalman_state.x  # time first
        mean, chol = theta_posterior_mean_and_chol(x, sigma_theta, dt, sigma_x)
        if eps_theta is None:
            eps_theta = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                    device=mean.device)
        return GibbsState(kalman_state=kalman_state, theta=mean + chol * eps_theta)

    def init(x, theta):
        # log_target stays None: the target density depends on theta, which
        # changes every step, so the Kalman kernel's cached target value
        # would be that of the previous theta. None makes it recompute.
        return GibbsState(
            kalman_state=KalmanSampler(x=x, updated=torch.ones(x.shape[:1] if chains else (),
                                                               dtype=torch.bool,
                                                               device=x.device)),
            theta=torch.as_tensor(theta, dtype=x.dtype, device=x.device))

    if chains:
        kernel.chain_axis = True
    return init, kernel
