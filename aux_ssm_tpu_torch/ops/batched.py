"""Helpers for explicitly batched small-matrix algebra on (..., d, d) tensors
(counterpart of `aux_ssm_tpu/ops/batched.py`)."""
import torch


def mT(M):
    """Batched matrix transpose."""
    return M.transpose(-1, -2)


def mv(M, v):
    """Batched matrix-vector product (..., i, j), (..., j) -> (..., i)."""
    if M.shape[-2:] == (1, 1):  # a product of scalars, not a batch of 1 x 1 matmuls
        return M[..., 0] * v
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def sym(M):
    """Symmetrize."""
    return 0.5 * (M + mT(M))


def bdiag(M):
    """Batched diagonal (..., d, d) -> (..., d)."""
    return torch.diagonal(M, dim1=-2, dim2=-1)
