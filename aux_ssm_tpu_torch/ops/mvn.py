"""Multivariate-normal math, Cholesky-parameterised (counterpart of
`aux_ssm_tpu/ops/mvn.py`: `logpdf`, `tril_log_det`, `rvs` and
`get_optimal_covariance`), and the scalar `norm_logpdf` the models share.

Non-finite rows of `chol` are "infinite-variance" dimensions that contribute
nothing; the 2-pi normalisation counts only finite diagonal entries."""
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def norm_logpdf(x, loc, scale):
    """log N(x; loc, scale^2), elementwise, as jax.scipy.stats.norm.logpdf
    computes it: -(log(2 pi scale^2) + (x - loc)^2 / scale^2) / 2. `scale` is
    a tensor or a Python float."""
    s2 = scale * scale
    z = x - loc
    log_norm = (torch.log((2.0 * math.pi) * s2) if isinstance(s2, torch.Tensor)
                else math.log((2.0 * math.pi) * s2))
    return (log_norm + z * z / s2) / -2.0


def tril_log_det(chol):
    """Log-determinant of a lower-triangular factor, ignoring non-finite
    diagonal entries."""
    diag = torch.diagonal(chol, dim1=-2, dim2=-1) if chol.ndim >= 2 else chol
    diag = torch.nan_to_num(diag, nan=1.0, posinf=1.0, neginf=1.0)
    return torch.nansum(torch.log(diag.abs()), dim=-1)


def logpdf(x, m, chol):
    """Gaussian log-density N(x; m, chol chol^T), broadcast over leading dims."""
    batch = torch.broadcast_shapes(x.shape[:-1], m.shape[:-1], chol.shape[:-2])
    diff = (x - m).expand(batch + x.shape[-1:])
    chol = chol.expand(batch + chol.shape[-2:])
    finfo = torch.finfo(chol.dtype)
    big = math.sqrt(finfo.max)
    chol_sat = torch.nan_to_num(chol, nan=big, posinf=big, neginf=-big)
    y = torch.linalg.solve_triangular(chol_sat, diff.unsqueeze(-1), upper=False)[..., 0]

    finite = torch.isfinite(torch.diagonal(chol, dim1=-2, dim2=-1))
    dim = finite.to(chol.dtype).sum(-1)
    log_norm = tril_log_det(chol) + 0.5 * dim * _LOG_2PI
    quad = torch.where(finite, y * y, 0.0).sum(-1)
    return torch.clamp(-0.5 * quad - log_norm, -finfo.max, finfo.max)


def rvs(m, chol, generator=None, eps=None):
    """One draw from N(m, chol chol^T), broadcast over leading dims. `eps`
    (the shape of `m`), if given, replaces the standard normals drawn from
    `generator`."""
    if eps is None:
        eps = torch.randn(m.shape, generator=generator, dtype=m.dtype, device=m.device)
    return m + (chol @ eps.unsqueeze(-1))[..., 0]


def get_optimal_covariance(chol_P, chol_Sig):
    """The Cholesky factor of the smallest covariance (Corenflos et al.,
    Sec. 3) that dominates both chol_P chol_P^T and chol_Sig chol_Sig^T.
    Scalars, 1-D factors and 1 x 1 factors take the elementwise maximum."""
    chol_P, chol_Sig = torch.as_tensor(chol_P), torch.as_tensor(chol_Sig)
    if (chol_P.ndim < 2 and chol_Sig.ndim < 2) or chol_P.shape[-1] == 1:
        return torch.maximum(chol_P, chol_Sig)
    # Whiten Sig by P, clamp its eigenvalues at 1 from above, unwhiten. The
    # result does not depend on the eigenvectors' signs or order.
    right = torch.linalg.solve_triangular(chol_P, chol_Sig, upper=False)
    w, v = torch.linalg.eigh(right.mT @ right)
    w = torch.clamp(w, max=1.0)
    left = chol_Sig @ (v / torch.sqrt(w)[..., None, :])
    return torch.linalg.cholesky(left @ left.mT)
