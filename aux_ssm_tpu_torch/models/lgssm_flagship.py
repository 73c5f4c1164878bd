"""The flagship target: a stationary LGSSM with T time steps, dx-dimensional
state and dx // 4 observations per step, and its auxiliary-Kalman factories
(counterpart of `__graft_entry__._build_lgssm_model` and of
`benchmarks/headline_ess.build_order2_factory`).

`build_arrays` draws the model and its data with NumPy in the same
`default_rng(seed)` call sequence as the JAX builder, so both give the same
arrays; the factories are plain torch. They serve C chains on the same data
at once, time first (x (T, C, dx), delta (C,); the dense batched layout of
`ops/lgssm.py`): the model's parameters and data are every chain's ((T[-1],
1, ...), read once for all chains), u, the gradients, R and Omega each
chain's, and the target gives one value a chain. One chain's factories are
the same at C = 1 (`kernels.kalman.one_chain_factories`).
"""
import numpy as np
import torch

from ..convert import lgssm_from_numpy
from ..kernels.kalman import chain_delta, one_chain_factories
from ..ops.chol import cholesky
from ..ops.lgssm import LGSSM, log_likelihood, make_target_logpdf


def build_arrays(T, dx, seed=0):
    """(m0, P0, Fs, Qs, bs, Hs, Rs, cs, ys) as float64 NumPy arrays."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dx)
    A = 0.5 * rng.standard_normal((dx, dx)) / np.sqrt(dx)
    F = 0.9 * np.linalg.matrix_power(eye + A / 8, 1)
    F = 0.95 * F / max(1.0, np.max(np.abs(np.linalg.eigvals(F))))
    Q = 0.3 * eye + 0.05 * np.ones((dx, dx))
    m0, P0 = np.zeros(dx), eye.copy()
    Fs = np.tile(F, (T - 1, 1, 1))
    Qs = np.tile(Q, (T - 1, 1, 1))
    bs = np.zeros((T - 1, dx))
    H = rng.standard_normal((max(1, dx // 4), dx)) / np.sqrt(dx)
    Hs = np.tile(H, (T, 1, 1))
    Rs = np.tile(0.5 * np.eye(H.shape[0]), (T, 1, 1))
    cs = np.zeros((T, H.shape[0]))

    x = rng.multivariate_normal(m0, P0)
    ys = np.zeros((T, H.shape[0]))
    for t in range(T):
        if t > 0:
            x = Fs[t - 1] @ x + rng.multivariate_normal(np.zeros(dx), Q)
        ys[t] = H @ x + rng.multivariate_normal(np.zeros(H.shape[0]), Rs[t])
    return m0, P0, Fs, Qs, bs, Hs, Rs, cs, ys


def build_model(T, dx, *, device, dtype, seed=0, chains=False):
    """The target and its first-order factories:
    (dynamics_factory, observations_factory, target_logpdf) over C chains
    (module docstring); without `chains`, one chain's: the same factories at
    C = 1 (`one_chain_factories`)."""
    target, ys = lgssm_from_numpy(*build_arrays(T, dx, seed), device=device, dtype=dtype)
    # A unit chain axis on what every chain shares.
    model = LGSSM(target.m0, target.P0, *(z[:, None] for z in target[2:]))
    data = ys[:, None]
    eyes = torch.eye(dx, dtype=dtype, device=device).expand(T, 1, dx, dx)
    zeros = torch.zeros((T, 1, dx), dtype=dtype, device=device)
    target_fn = make_target_logpdf(data, model, keep_batch=True)  # (T, C, dx) -> (C,)

    def dynamics_factory(_x):
        return model[:5]

    def observations_factory(x, u, delta):
        # u + delta/2 * grad log g(x): the gradient of the potential is plain
        # torch autograd, outside any kernel (of the chains' sum: each
        # chain's gradient its own).
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(log_likelihood(data, xg, model), xg)
        half = 0.5 * chain_delta(delta)
        return u + half * grad, eyes, half[..., None] * eyes, zeros

    factories = (dynamics_factory, observations_factory, target_fn)
    return factories if chains else one_chain_factories(*factories)


def build_order2_factory(T, dx, *, device, dtype, seed=0, chains=False):
    """(dynamics_factory, first-order factory, second-order factory,
    target_logpdf) over C chains, or with `chains` false one chain's, as
    `build_model`'s. The Gaussian potential's Hessian is the constant
    -H^T R^-1 H per step, so Omega = (H^T R^-1 H + 2 I / delta)^-1."""
    arrays = build_arrays(T, dx, seed)
    dyn, obs1, target_fn = build_model(T, dx, device=device, dtype=dtype, seed=seed,
                                       chains=True)
    H, R = arrays[5][0], arrays[6][0]
    hess = torch.as_tensor(-(H.T @ np.linalg.solve(R, H)), dtype=dtype, device=device)
    eye = torch.eye(dx, dtype=dtype, device=device)
    zeros = torch.zeros((T, 1, dx), dtype=dtype, device=device)

    def obs2(x, u, delta):
        aux1 = obs1(x, u, delta)[0]  # u + delta/2 * grad
        dl = chain_delta(delta)
        grad = (aux1 - u) / (0.5 * dl)
        omega = torch.cholesky_inverse(cholesky(-hess + 2.0 * eye / dl[..., None]))
        rhs = 2.0 * u / dl + grad - x @ hess.T
        aux_ys = (omega @ rhs[..., None])[..., 0]
        return aux_ys, eye.expand(T, 1, dx, dx), omega.expand(x.shape + (dx,)), zeros

    factories = (dyn, obs1, obs2, target_fn)
    return factories if chains else one_chain_factories(*factories)
