"""Feynman–Kac model interface for cSMC samplers (counterpart of
`aux_ssm_tpu/kernels/csmc_base.py`).

Four component interfaces describe the model:

  M0 : Distribution          initial proposal / model distribution
  G0 : UnivariatePotential   initial potential (weight at t=0)
  Mt : Dynamics              proposal / model transition kernels
  Gt : Potential             transition potentials (weights at t >= 1)

`Dynamics` and `Potential` carry `params`, a tuple (possibly nested, or a
dict) of tensors whose leading axis is time. The cSMC loop hands each method
one time step of them.

Broadcast convention: particles are (..., N, d) and every per-step parameter
has the leading shape `...` (empty for one step, (T-1,) for all steps at
once). Methods insert the particle axis themselves (`p.unsqueeze(-2)` for a
(..., d) parameter, `p[..., None, None]` for a scalar one), so one method
serves the step loop and the batched pair-factor precomputes alike.

Random draws come from noise: `Distribution.sample_from_noise(eps)` and
`Dynamics.sample_from_noise(eps, x_t, params)` map standard normals of the
particles' shape to a sample (every location-scale family can); the cSMC
step draws that noise up front, from a `torch.Generator` or given.
"""
import math
from dataclasses import dataclass, replace
from typing import Any

import torch

_NOT_IMPLEMENTED_MSG = (
    "logpdf is not implemented for {} but was called; backward-sampling "
    "variants require a valid logpdf — implement it or use backward=False."
)
_LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class CSMCState:
    """State of a cSMC chain: reference trajectory (T, d) and the per-step
    update indicator (T,) (picked index != 0)."""
    x: torch.Tensor
    updated: torch.Tensor


class UnivariatePotential:
    """Potential x -> log G_0(x), batched over the particle axis."""

    def __call__(self, x):
        raise NotImplementedError


class Distribution:
    """A distribution over one time step with optional logpdf."""

    def sample_from_noise(self, eps):
        raise NotImplementedError

    def logpdf(self, x):
        raise NotImplementedError(_NOT_IMPLEMENTED_MSG.format(type(self).__name__))


@dataclass(frozen=True)
class Dynamics:
    """Conditional distribution x_{t+1} | x_t with per-time-step params.

    Optional protocol: `logpdf_factors(x_prev, x_next, params)` ->
    (row_feat (..., N, k), col_feat (..., N, k), row_bias (..., N),
    col_bias (..., N)) factorising logpdf(x_next[j] | x_prev[i]) over all
    pairs (i, j) as row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j].
    Every Gaussian transition has this form; it lets the cSMC sweeps run
    as the factor kernels of `ops/cuda/csmc_fwd.py`."""
    params: Any = None

    def sample_from_noise(self, eps, x_t, params):
        raise NotImplementedError

    def logpdf(self, x_next, x_t, params):
        raise NotImplementedError(_NOT_IMPLEMENTED_MSG.format(type(self).__name__))


@dataclass(frozen=True)
class Potential:
    """Potential (x_{t+1}, x_t) -> log G_t with per-time-step params.

    `prev_dependent = False` marks potentials that read only x_{t+1}: they
    then fold into a per-column bias of the pair factors."""
    params: Any = None
    prev_dependent = True

    def __call__(self, x_next, x_t, params):
        raise NotImplementedError


def _centred(row_feat, col_feat, col_const):
    """The pair factors from whitened means and points, both sides shifted by
    one vector c per step (or node): the mean of the two sides' particle
    means. -1/2 |a - b|^2 does not change under a shared shift, so every
    score rb_i + cb_j + rf_i . cf_j is the same; but the biases and products
    stay of the particles' spread instead of their distance from 0, and
    float32 stops cancelling terms far larger than the scores (|x / sig| ~ 50
    at d = 64 gives terms of 1e5 for scores of 1e2)."""
    c = 0.5 * (row_feat.mean(-2, keepdim=True) + col_feat.mean(-2, keepdim=True))
    row_feat, col_feat = row_feat - c, col_feat - c
    return (row_feat, col_feat, -0.5 * (row_feat ** 2).sum(-1),
            -0.5 * (col_feat ** 2).sum(-1) + col_const)


def diag_gaussian_pair_factors(mean_prev, x_next, sig):
    """Pair-factorise N(x_next[j]; mean_prev[i], diag(sig^2)) over (..., N, d)
    rows; `sig` a scalar or (d,), or per step (..., 1, 1) or (..., 1, d).
    Centred (`_centred`)."""
    d = x_next.shape[-1]
    sig = torch.as_tensor(sig, dtype=x_next.dtype, device=x_next.device)
    if sig.dim() <= 1:
        sig = sig.expand(d)
        const = -torch.log(sig).sum()
    else:  # per step: the constant (..., 1) against (..., N) biases
        const = -torch.log(sig.expand(*sig.shape[:-1], d)).sum(-1)
    return _centred(mean_prev / sig, x_next / sig, const - 0.5 * d * _LOG_2PI)


def chol_gaussian_pair_factors(mean_prev, x_next, chol):
    """Pair-factorise N(x_next[j]; mean_prev[i], chol chol^T) over (..., N, d)
    rows: both sides whitened by chol^{-1}, then centred (`_centred`)."""
    d = x_next.shape[-1]

    def whiten(z):
        return torch.linalg.solve_triangular(chol, z.transpose(-1, -2),
                                             upper=False).transpose(-1, -2)

    return _centred(whiten(mean_prev), whiten(x_next),
                    -torch.log(torch.diagonal(chol)).sum() - 0.5 * d * _LOG_2PI)


def shared_by_chains(component):
    """`component` (a Dynamics or Potential) for C chains on a leading axis
    that share its per-step params: each param gets a unit chain axis (1,
    T-1, ...), which broadcasts against the chains' (C, T-1, ...) and which
    the PIT tree expands to C (`kernels/pit.py`) without copying."""
    return replace(component, params=tree_map(lambda z: z[None], component.params))


def mark_chains(init_kernel, chains):
    """(init, kernel) with the kernel marked `chain_axis` when `chains`: a
    kernel over a leading chain axis, which `experiments/cli.py` runs as one
    batched step."""
    if chains:
        init_kernel[1].chain_axis = True
    return init_kernel


def rows(p, x):
    """A per-step (..., d) parameter aligned with particles (..., N, d)."""
    return p.unsqueeze(-2) if x.dim() > p.dim() else p


def tree_map(fn, tree):
    """Apply `fn` to every tensor of a nested tuple/list/dict (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, z) for z in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
