"""Gaussian linearisation rules for conditional dynamics (counterpart of
`aux_ssm_tpu/ops/linearise.py`).

Each rule maps a conditional mean/covariance pair (mean(x, params),
cov(x, params)) and an expansion point x* (plus, for the sigma-point rules, a
covariance P*) to an affine-Gaussian approximation (F, Q, b) with
  p(x' | x) ~= N(x'; F x + b, Q).

`extended` works under `torch.func.vmap` over a batch of expansion points;
`extended_steps` linearises at every step of C chains' trajectories, each
chain with its own params, in one call.
The sigma points and weights are built in NumPy (this module's own copy of
the construction) and moved to the expansion point's dtype and device.
"""
import math

import numpy as np
import torch


def extended(mean, cov, params, x_star, _P_star=None):
    """First-order (Taylor) linearisation at x*: the Jacobian by forward mode
    for square or tall maps, by reverse mode for wide ones (as the JAX
    package picks it)."""
    b = mean(x_star, params)
    jac = torch.func.jacrev if b.shape[0] < x_star.shape[0] else torch.func.jacfwd
    F = jac(mean, argnums=0)(x_star, params)
    Q = cov(x_star, params)
    return F, Q, b - F @ x_star


def extended_steps(mean, cov, xs, params):
    """`extended` at every expansion point of C chains' trajectories xs (n,
    C, d), chain c with params `params[c]` (a tensor with a leading axis of
    C), all at once (one nested `torch.func.vmap`). Returns (Fs, Qs, bs)
    with the leading axes of xs."""
    steps = torch.func.vmap(lambda z, p: extended(mean, cov, p, z), in_dims=(0, None))
    # contiguous: forward-mode AD refuses an expanded (stride 0) chain axis
    out = torch.func.vmap(steps, in_dims=(1, 0))(xs.contiguous(), params)
    return tuple(z.transpose(0, 1) for z in out)


def cubature(mean, cov, params, x_star, P_star):
    """Spherical cubature (3rd-degree) statistical linearisation."""
    return _sigma_point_linearise(mean, cov, params, x_star, P_star, _cubature_points)


def gauss_hermite(mean, cov, params, x_star, P_star, order=3):
    """Gauss-Hermite statistical linearisation of the given order."""
    return _sigma_point_linearise(mean, cov, params, x_star, P_star,
                                  lambda d: _gauss_hermite_points(d, order))


def _sigma_point_linearise(mean, cov, params, x_star, P_star, get_points):
    chol = torch.linalg.cholesky(P_star)
    w, xi = get_points(x_star.shape[0])
    w = torch.as_tensor(w, dtype=x_star.dtype, device=x_star.device)
    xi = torch.as_tensor(xi, dtype=x_star.dtype, device=x_star.device)

    points = x_star[None, :] + (chol @ xi).T
    f_pts = torch.func.vmap(mean, in_dims=(0, None))(points, params)
    m_f = w @ f_pts

    # Cross-covariance of x and f(x) under the sigma-point measure, then the
    # statistically linearised slope F = Psi^T P*^{-1}.
    Psi = ((points - x_star[None, :]).T * w[None, :]) @ (f_pts - m_f[None, :])
    F = torch.cholesky_solve(Psi, chol).T

    v_pts = torch.func.vmap(cov, in_dims=(0, None))(points, params)
    v_f = torch.einsum("s,sij->ij", w, v_pts)

    Phi = ((f_pts - m_f[None, :]).T * w[None, :]) @ (f_pts - m_f[None, :])
    temp = F @ chol
    Q = Phi - temp @ temp.T + v_f
    return F, Q, m_f - F @ x_star


# --- sigma-point construction (NumPy, float64) --------------------------------

def _cubature_points(n_dim):
    w = np.full((2 * n_dim,), 1.0 / (2 * n_dim))
    xi = np.concatenate([np.eye(n_dim), -np.eye(n_dim)], axis=0) * math.sqrt(n_dim)
    return w, xi.T


def _gauss_hermite_points(n_dim, order):
    """Tensor-product Gauss-Hermite points and weights for N(0, I_n), in the
    probabilists' convention (the physicists' nodes times sqrt(2))."""
    nodes, w_1d = np.polynomial.hermite.hermgauss(order)
    w_1d = w_1d / math.sqrt(math.pi)

    grids = np.meshgrid(*([nodes] * n_dim), indexing="ij")
    xi = math.sqrt(2.0) * np.stack([g.ravel() for g in grids], axis=0)

    w_grids = np.meshgrid(*([w_1d] * n_dim), indexing="ij")
    w = np.prod(np.stack([g.ravel() for g in w_grids], axis=0), axis=0)
    return w, xi
