"""Cholesky factorisations with the JAX package's failure semantics
(counterpart of `aux_ssm_tpu/ops/chol.py`)."""
import torch


def cholesky(M):
    """Lower Cholesky factor of a batch of SPD matrices. Where a matrix is not
    positive definite the factor is all NaN, as `jnp.linalg.cholesky` gives,
    instead of the exception `torch.linalg.cholesky` raises."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def safe_cholesky(P):
    """Cholesky of a (supposedly) PSD matrix, robust to slight asymmetry or
    tiny negative eigenvalues: symmetrise, add 32 eps(dtype) * trace / d to
    the diagonal, factor, and replace non-finite entries by 0 so that a
    rank-deficient covariance yields a usable (zeroed) factor."""
    P = 0.5 * (P + P.transpose(-1, -2))
    d = P.shape[-1]
    scale = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)[..., None, None] / d
    jitter = 32.0 * torch.finfo(P.dtype).eps * scale
    P = P + jitter * torch.eye(d, dtype=P.dtype, device=P.device)
    return torch.nan_to_num(cholesky(P), nan=0.0, posinf=0.0, neginf=0.0)
