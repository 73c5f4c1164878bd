"""Multivariate-normal log-density, Cholesky-parameterised (counterpart of
`aux_ssm_tpu/ops/mvn.py`: `logpdf` and `tril_log_det`).

Non-finite rows of `chol` are "infinite-variance" dimensions that contribute
nothing; the 2-pi normalisation counts only finite diagonal entries."""
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


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
