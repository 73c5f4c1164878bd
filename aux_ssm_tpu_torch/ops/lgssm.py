"""Linear-Gaussian state-space model container and trajectory log-densities
(counterpart of `aux_ssm_tpu/ops/lgssm.py`).

Shapes, unbatched layout: m0 (dx,), P0 (dx, dx), Fs/Qs (T-1, dx, dx),
bs (T-1, dx), Hs (T, dy, dx), Rs (T, dy, dy), cs/ys (T, dy), xs (T, dx).
Batched scalar layout (B independent filters with dx = dy = 1, the spatial
model): m0 (B, 1), P0 (B, 1, 1), Fs/Qs (T-1, B, 1, 1), bs (T-1, B, 1),
Hs/Rs (T, B, 1, 1), cs/ys (T, B, 1), xs (T, B, 1); every density is summed
over B, or with `keep_batch` kept one a filter (B,): B independent chains
of a scalar model (`kernels.kalman.get_kernel(..., chains=True)`).
Dense batched layout (C independent filters of any dx, dy: C chains of a
model, the same (T, B, d) convention): m0 (C, dx), P0 (C, dx, dx), Fs/Qs
(T-1, C, dx, dx), bs (T-1, C, dx), Hs (T, C, dy, dx), Rs (T, C, dy, dy),
cs/ys (T, C, dy), xs (T, C, dx). Any of them may instead broadcast to that
shape (m0 (dx,), Fs (T-1, 1, dx, dx) or an `expand`ed view): a parameter
that every chain shares then reaches the kernels once for all chains
(`ops/cuda/kalman_fused.py`). Every density is summed over C, or with
`keep_batch` one a chain (C,). Both batched layouts are told from the
unbatched one by `bs.ndim == 3`, and from each other by dx = dy = 1.

Missing data: NaN entries of `ys` are unobserved components. Every function
uses the exact masked projection of the observation model (rows of H and
entries of c zeroed, R restricted to the observed block with a unit diagonal
on the missing one, missing innovations zeroed), which equals deleting the
missing rows while keeping shapes static and all values finite.
"""
import math
from typing import NamedTuple

import torch

from .batched import mv
from .chol import cholesky
from .mvn import logpdf as mvn_logpdf

_LOG_2PI = math.log(2.0 * math.pi)


class LGSSM(NamedTuple):
    """Parameters of a linear-Gaussian SSM."""
    m0: torch.Tensor
    P0: torch.Tensor
    Fs: torch.Tensor
    Qs: torch.Tensor
    bs: torch.Tensor
    Hs: torch.Tensor
    Rs: torch.Tensor
    cs: torch.Tensor


def batched_scalar_layout(bs, cs):
    """True for the batched scalar layout (bs (T-1, B, 1), cs (T, B, 1)),
    False for the unbatched one and the dense batched one."""
    return bs.ndim == 3 and bs.shape[-1] == 1 and cs.shape[-1] == 1


def _eye_like(R):
    return torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)


def _masked_R(mask, R):
    """R restricted to the observed block, unit diagonal on the missing one."""
    both = mask[..., :, None] & mask[..., None, :]
    R_eff = torch.where(both, torch.nan_to_num(R), 0.0)
    return R_eff + _eye_like(R) * (1.0 - mask.to(R.dtype)[..., :, None])


def mask_observation(y, H, c, R):
    """Project an observation model onto the observed components of `y`.

    Returns `(y_eff, H_eff, c_eff, R_eff, mask)`. `where` is used, never a
    product with the mask: H, R, c may themselves be NaN at missing steps
    and NaN * 0 = NaN.
    """
    mask = torch.isfinite(y)
    H_eff = torch.where(mask[..., :, None], torch.nan_to_num(H), 0.0)
    c_eff = torch.where(mask, torch.nan_to_num(c), 0.0)
    y_eff = torch.where(mask, torch.nan_to_num(y), 0.0)
    return y_eff, H_eff, c_eff, _masked_R(mask, R), mask


def _masked_step_logpdf(y, pred, R):
    """log N(y_obs; pred_obs, R_obs) over the observed components of `y`;
    broadcasts over leading batch dims."""
    mask = torch.isfinite(y)
    n_obs = mask.to(pred.dtype).sum(-1)
    chol = cholesky(_masked_R(mask, R))
    innov = torch.where(mask, torch.nan_to_num(y) - torch.nan_to_num(pred), 0.0)
    w = torch.linalg.solve_triangular(chol, innov.unsqueeze(-1), upper=False)[..., 0]
    log_det = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (w * w).sum(-1) - log_det - 0.5 * n_obs * _LOG_2PI


def log_likelihood(ys, xs, lgssm, keep_batch=False):
    """log p(y_{0:T} | x_{0:T}) for a given trajectory; missing observation
    components are marginalised out exactly. With `keep_batch` (a batched
    layout), one value a filter, (B,)."""
    *_, Hs, Rs, cs = lgssm
    pred_ys = mv(Hs, xs) + cs
    if cs.shape[-1] == 1:
        mask = torch.isfinite(ys[..., 0])
        var = Rs[..., 0, 0]
        diff = torch.where(mask, torch.nan_to_num(ys[..., 0]) - pred_ys[..., 0], 0.0)
        out = -0.5 * (diff * diff / var + torch.log(var) + _LOG_2PI)
        out = torch.where(mask, out, 0.0)
        return out.sum(0) if keep_batch else out.sum()
    out = _masked_step_logpdf(ys, pred_ys, Rs)
    return out.sum(0) if keep_batch else out.sum()


def _first_logpdf(x0, m0, P0):
    """log N(x_0; m0, P0)."""
    if m0.shape[-1] == 1:
        var0 = P0[..., 0, 0]
        d0 = x0[..., 0] - m0[..., 0]
        return -0.5 * (d0 * d0 / var0 + torch.log(var0) + _LOG_2PI)
    return mvn_logpdf(x0, m0, cholesky(P0))


def prior_logpdf(xs, lgssm, keep_batch=False):
    """log p(x_{0:T}) of a trajectory under the LGSSM dynamics; with
    `keep_batch` (a batched layout), one value a filter, (B,)."""
    m0, P0, Fs, Qs, bs, *_ = lgssm
    pred_xs = mv(Fs, xs[:-1]) + bs
    if keep_batch:
        first = _first_logpdf(xs[0], m0, P0)
        first = torch.where(torch.isnan(first), 0.0, first)
        if m0.shape[-1] == 1:
            dq = xs[1:, ..., 0] - pred_xs[..., 0]
            varq = Qs[..., 0, 0]
            trans = -0.5 * (dq * dq / varq + torch.log(varq) + _LOG_2PI)
        else:
            trans = mvn_logpdf(xs[1:], pred_xs, cholesky(Qs))
        return first + torch.nansum(trans, 0)
    out = torch.nansum(_first_logpdf(xs[0], m0, P0))
    if m0.shape[-1] == 1:
        varq = Qs[..., 0, 0]
        dq = xs[1:, ..., 0] - pred_xs[..., 0]
        trans = -0.5 * (dq * dq / varq + torch.log(varq) + _LOG_2PI)
    else:
        trans = mvn_logpdf(xs[1:], pred_xs, cholesky(Qs))
    return out + torch.nansum(trans)


def trajectory_logdensity(ys, xs, lgssm, keep_batch=False):
    """log p(x_{0:T}) + log p(y_{0:T} | x_{0:T}). Unbatched and dense batched
    layouts: the t = 0 terms in plain torch, the t >= 1 steps through
    `kalman_fused.logdensity_steps` (all chains in one launch; its plain
    version where max(dx, dy) has no kernel instance in the dtype). Batched
    scalar layout: the elementwise closed forms of `log_likelihood` and
    `prior_logpdf`. A batched layout sums over its filters, or with
    `keep_batch` gives one value a filter (B,)."""
    from .cuda import kalman_fused  # that module imports this one
    from .cuda._build import has_instance

    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lgssm
    if batched_scalar_layout(bs, cs):
        return (log_likelihood(ys, xs, lgssm, keep_batch)
                + prior_logpdf(xs, lgssm, keep_batch))
    steps = (kalman_fused.logdensity_steps
             if has_instance(xs.shape[-1], ys.shape[-1], dtype=xs.dtype)
             else kalman_fused.logdensity_steps_plain)(
        Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], xs[:-1], xs[1:])
    pred0 = mv(Hs[0], xs[0]) + cs[0]
    first = _first_logpdf(xs[0], m0, P0) + _masked_step_logpdf(ys[0], pred0, Rs[0])
    if keep_batch:
        return first + steps.sum(0)
    return first.sum() + steps.sum()


def posterior_logpdf(ys, xs, ell, lgssm, keep_batch=False):
    """log p(x_{0:T} | y_{0:T}) = log p(y|x) - log p(y) + log p(x); with
    `keep_batch`, per filter of a batched layout (`ell` (B,))."""
    return trajectory_logdensity(ys, xs, lgssm, keep_batch) - ell


def make_target_logpdf(ys, lgssm, keep_batch=False):
    """Precomputed-closure form of `prior_logpdf(x) + log_likelihood(ys, x)`
    for a FIXED target LGSSM.

    Every trajectory-independent factor (masked-observation Cholesky,
    dynamics Cholesky, their triangular inverses, log-determinants) is
    computed once here; the returned `logpdf(xs)` is matmuls and sums only.
    Requires finite covariances (missing data is still handled exactly
    through the NaN mask of `ys`). With `keep_batch`, C chains of the one
    target in the dense batched layout: `ys` (T, 1, dy) and the per-step
    parameters (T[-1], 1, ...), every chain's; xs (T, C, dx) gives one value
    a chain (C,).
    """
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lgssm
    dx = m0.shape[-1]

    # ---- observation factors (constant given the ys NaN pattern) ----
    mask = torch.isfinite(ys)
    n_obs_tot = mask.to(Rs.dtype).sum()
    H_eff = torch.where(mask[..., :, None], torch.nan_to_num(Hs), 0.0)
    c_eff = torch.where(mask, torch.nan_to_num(cs), 0.0)
    y_eff = torch.where(mask, torch.nan_to_num(ys), 0.0)

    scalar_obs = cs.shape[-1] == 1
    if scalar_obs:
        var = Rs[..., 0, 0]
        obs_const = -torch.where(mask[..., 0], 0.5 * (torch.log(var) + _LOG_2PI), 0.0).sum()
    else:
        chol_R = cholesky(_masked_R(mask, Rs))
        inv_chol_R = torch.linalg.solve_triangular(
            chol_R, _eye_like(Rs).expand(chol_R.shape), upper=False)
        obs_const = -torch.log(torch.diagonal(chol_R, dim1=-2, dim2=-1)).sum() \
            - 0.5 * n_obs_tot * _LOG_2PI

    # ---- dynamics factors ----
    scalar_dyn = dx == 1
    if scalar_dyn:
        var0, varq = P0[..., 0, 0], Qs[..., 0, 0]
        dyn_const = -0.5 * torch.nansum(torch.log(var0) + _LOG_2PI) \
            - 0.5 * torch.nansum(torch.log(varq) + _LOG_2PI)
    else:
        chol_P0 = cholesky(P0)
        chol_Qs = cholesky(Qs)
        eye_x = _eye_like(Qs)
        inv_chol_P0 = torch.linalg.solve_triangular(
            chol_P0, eye_x.expand(chol_P0.shape), upper=False)
        inv_chol_Qs = torch.linalg.solve_triangular(
            chol_Qs, eye_x.expand(chol_Qs.shape), upper=False)
        n_trans = Qs.shape[0] * (1 if Qs.ndim == 3 else Qs.shape[1])
        n0 = 1 if P0.ndim == 2 else P0.shape[0]
        dyn_const = (
            -torch.log(torch.diagonal(chol_P0, dim1=-2, dim2=-1)).sum()
            - 0.5 * n0 * dx * _LOG_2PI
            - torch.log(torch.diagonal(chol_Qs, dim1=-2, dim2=-1)).sum()
            - 0.5 * n_trans * dx * _LOG_2PI)

    def total(z, chain_axis=1, sum_=torch.sum):
        """The sum of z, or with `keep_batch` one sum a chain."""
        if not keep_batch:
            return sum_(z)
        dims = tuple(i for i in range(z.dim()) if i != chain_axis)
        return sum_(z, dims) if dims else z

    def logpdf(xs):
        # log p(y | x): masked innovations whitened by the precomputed factor.
        innov = torch.where(mask, y_eff - (mv(H_eff, xs) + c_eff), 0.0)
        if scalar_obs:
            out = obs_const - 0.5 * total(torch.where(mask[..., 0], innov[..., 0] ** 2 / var, 0.0))
        else:
            w = mv(inv_chol_R, innov)
            out = obs_const - 0.5 * total(w * w)
        # log p(x): whitened transition residuals.
        d0 = xs[0] - m0
        dq = xs[1:] - (mv(Fs, xs[:-1]) + bs)
        if scalar_dyn:
            return out + dyn_const - 0.5 * total(d0[..., 0] ** 2 / var0, 0, torch.nansum) \
                - 0.5 * total(dq[..., 0] ** 2 / varq, 1, torch.nansum)
        w0 = mv(inv_chol_P0, d0)
        wq = mv(inv_chol_Qs, dq)
        return out + dyn_const - 0.5 * total(w0 * w0, 0, torch.nansum) \
            - 0.5 * total(wq * wq, 1, torch.nansum)

    return logpdf
