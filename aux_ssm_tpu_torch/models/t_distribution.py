"""Multivariate Student-t with banded grid precision (counterpart of
`aux_ssm_tpu/models/t_distribution.py`).

The banded precision of the d x d grid is applied as a 2-D convolution with
the equivalent stencil (`torch.nn.functional.conv2d`, zero padding = grid
clipping), batched over leading dims; a dense-matrix path is kept for
generic precisions. The convolution must stay IEEE float32 on the card: the
package turns cuDNN's TF32 off at import.
"""
import torch
import torch.nn.functional as F


def apply_precision_stencil(v, stencil, d):
    """y = P v for grid-shaped fields: v (..., d*d) -> (..., d*d)."""
    k = stencil.shape[0]
    kernel = stencil.reshape(1, 1, k, k).to(dtype=v.dtype, device=v.device)
    out = F.conv2d(v.reshape(-1, 1, d, d), kernel, padding=k // 2)
    return out.reshape(v.shape)


def quad_form_stencil(x, mu, stencil, d):
    """(x-mu)^T P (x-mu) with the stencil apply; batched over leading dims."""
    diff = x - mu
    return (diff * apply_precision_stencil(diff, stencil, d)).sum(-1)


def logpdf(x, mu, nu, prec=None, stencil=None, d=None):
    """Unnormalised multivariate-t log-density
    -(nu + dim)/2 * log(1 + (x-mu)^T P (x-mu)/nu).

    Pass either a dense `prec` matrix, or a grid `stencil` + grid side `d`.
    Batched over leading dims of x/mu.
    """
    x, mu = torch.broadcast_tensors(x, mu)
    dim = x.shape[-1]
    if stencil is not None:
        norm = quad_form_stencil(x, mu, stencil, d)
    else:
        diff = x - mu
        norm = ((diff @ prec.T) * diff).sum(-1)
    return -0.5 * (nu + dim) * torch.log1p(norm / nu)


def sample(mu, nu, chol_prec, n=None, generator=None):
    """Draws from the multivariate t with the given upper Cholesky factor of
    the precision (scale-mixture construction): one draw of `mu`'s shape, or
    `n` draws stacked on a leading axis."""
    shape = mu.shape if n is None else (n,) + mu.shape[-1:]
    kw = dict(generator=generator, dtype=mu.dtype, device=mu.device)
    eps = torch.randn(shape, **kw)
    y = torch.linalg.solve_triangular(chol_prec, eps.unsqueeze(-1), upper=True)[..., 0]
    conc = torch.full(shape[:-1], 0.5 * nu, dtype=mu.dtype, device=mu.device)
    u = 2.0 * torch._standard_gamma(conc, generator=generator) / nu
    return mu + y / torch.sqrt(u)[..., None]
