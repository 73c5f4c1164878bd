"""Pathwise backward sampling from the smoothing distribution of an LGSSM
(counterpart of `aux_ssm_tpu/ops/sampling.py`).

Given filtered moments (ms, Ps), one joint smoothing draw x_{0:T} composes
the backward maps x_t = G_t x_{t+1} + e_t, where e_t carries the sampled
noise. Composition of affine maps is associative, so the trajectory is a
reverse associative scan or a reverse sequential loop. The maps and the scan
go through the wrappers of `ops/cuda/`; the last step is plain torch.
"""
import torch

from .batched import mT, mv, sym
from .chol import safe_cholesky
from .lgssm import LGSSM
from .cuda.filter_scan import affine_scan
from .cuda.kalman_fused import backward_maps


def sampling(eps, ms, Ps, lgssm: LGSSM, parallel: bool):
    """Draw one trajectory from p(x_{0:T} | y_{0:T}).

    Parameters
    ----------
    eps : Tensor (T, dx)
        Standard normal noise of the draw (the JAX package draws it from its
        key inside; the port takes it explicitly).
    ms, Ps : filtered means/covariances from `filtering`
    lgssm : LGSSM
    parallel : bool
        Reverse associative scan (True) or reverse sequential loop.

    Returns
    -------
    xs : Tensor with the same shape as `ms`.
    """
    gains, incs = _backward_maps(eps, ms, Ps, lgssm.Fs, lgssm.Qs, lgssm.bs)
    if parallel:
        return affine_scan(gains, incs, reverse=True)[1]
    x = incs[-1]
    xs = [x]
    for t in range(incs.shape[0] - 2, -1, -1):
        x = sampling_operator((gains[t + 1], x), (gains[t], incs[t]))[1]
        xs.append(x)
    return torch.stack(xs[::-1])


def sampling_operator(elem1, elem2):
    """Composition of affine maps: (G1, e1) then (G2, e2) -> (G2 G1, G2 e1 + e2)."""
    G1, e1 = elem1
    G2, e2 = elem2
    if G1.shape[-1] == 1:  # scalar fast path
        g1, g2 = G1[..., 0, 0], G2[..., 0, 0]
        return (g2 * g1)[..., None, None], (g2 * e1[..., 0])[..., None] + e2
    return G2 @ G1, mv(G2, e1) + e2


def backward_map_moments(F, Q, b, m, P):
    """Moments of the backward conditional x_t | x_{t+1} at filtered (m, P):
    mean = inc_m + gain @ x_{t+1}, covariance = L L^T. Batched over leading
    dims."""
    dx = m.shape[-1]
    S = sym(F @ P @ mT(F) + Q)
    if dx == 1:
        gain = P * F / S
        L = torch.sqrt(torch.clamp(P - gain @ S @ mT(gain), min=0.0))
    else:
        chol_S = safe_cholesky(S)
        gain = mT(torch.cholesky_solve(F @ P, chol_S))
        # A zero-uncertainty step gives a singular covariance; safe_cholesky
        # returns a usable (zeroed) factor there.
        L = safe_cholesky(P - gain @ S @ mT(gain))
    inc_m = m - mv(gain, mv(F, m) + b)
    return inc_m, L, gain


def _backward_maps(eps, ms, Ps, Fs, Qs, bs):
    gains, incs = backward_maps(Fs, Qs, bs, ms[:-1], Ps[:-1], eps[:-1])
    # The last step is handled outside the kernel.
    P_last = Ps[-1]
    if ms.shape[-1] == 1:
        L_last = torch.sqrt(torch.clamp(P_last, min=0.0))
    else:
        L_last = safe_cholesky(P_last)
    last_inc = ms[-1] + mv(L_last, eps[-1])
    gains = torch.cat([gains, torch.zeros_like(P_last)[None]])
    incs = torch.cat([incs, last_inc[None]])
    return gains, incs
