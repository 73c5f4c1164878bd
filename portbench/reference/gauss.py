"""Gaussian densities and factors shared by the references."""
import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def norm_logpdf(x, loc, scale):
    """log N(x; loc, scale^2), elementwise."""
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=x.dtype, device=x.device)) \
        - 0.5 * LOG_2PI


def chol(S):
    """Lower Cholesky factor of symmetric positive-definite matrices, after
    symmetrising; a jitter of 32 ulp of the mean diagonal keeps a covariance
    that rounding left on the edge of definiteness factorable."""
    S = 0.5 * (S + S.mT)
    d = S.shape[-1]
    scale = torch.diagonal(S, dim1=-2, dim2=-1).mean(-1)[..., None, None]
    eye = torch.eye(d, dtype=S.dtype, device=S.device)
    return torch.linalg.cholesky(S + 32.0 * torch.finfo(S.dtype).eps * scale * eye)


def mvn_logpdf(x, mean, L, mm=torch.matmul):
    """log N(x; mean, L L^T) over the last axis, broadcast over leading
    axes; L one lower-triangular (d, d) factor, whitening as a product."""
    d = L.shape[-1]
    eye = torch.eye(d, dtype=L.dtype, device=L.device)
    z = mm(x - mean, torch.linalg.solve_triangular(L, eye, upper=False).mT)
    return -0.5 * (z * z).sum(-1) - torch.log(torch.diagonal(L)).sum() - 0.5 * d * LOG_2PI


def matvec(A, x, mm=torch.matmul):
    """A x over the last axis, A (..., m, n), x (..., n)."""
    return mm(A, x[..., None])[..., 0]


def tf32(x):
    """float32 values rounded to TF32's 10-bit mantissa, to nearest, ties to
    even: what a tensor core reads of a product's operands."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_matmul(a, b):
    """a @ b as TF32 tensor cores compute it: operands rounded to TF32,
    products accumulated in float32. Emulated, so that the precision does
    not hang on which cuBLAS kernel a shape gets (small float32 products
    run on FMA units even where TF32 is allowed) or on the device."""
    return torch.matmul(tf32(a), tf32(b))


def products(tf32_on):
    """The matrix product of a reference: TF32's, or IEEE float."""
    return tf32_matmul if tf32_on else torch.matmul
