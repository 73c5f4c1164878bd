"""Divide-and-conquer Gaussian-bridge trajectory sampler (counterpart of
`aux_ssm_tpu/ops/dnc_sampling.py`), kept as the JAX package keeps it: a
proof of concept beside the associative-scan sampler (`ops/sampling.py`),
which is the one the samplers use. It has no kernel of its own: each tree
level is one batched PyTorch call.

The backward conditionals x_t | x_{t+1} of an LGSSM are affine-Gaussian
maps (E, g, L), x_t | x_{t+1} ~ N(E x_{t+1} + g, L). Composing the maps of
two adjacent segments [l, m] and [m, r] gives the map of [l, r] and the
bridge law of the midpoint, x_m | (x_l, x_r) ~ N(G x_l + Gamma x_r + w, V).
Sampling goes root-down: the endpoints first, then each level's midpoints
at once.
"""
import warnings

import numpy as np
import torch

from .chol import safe_cholesky
from .lgssm import LGSSM
from .mvn import rvs


def _pos_solve_t(S, B):
    """(S^{-1} B)^T for symmetric positive definite S, by Cholesky."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(S)).mT


def sampling(ms, Ps, lgssm: LGSSM, generator=None, noise=None):
    """Draw one trajectory from p(x_{0:T} | y_{0:T}) through the tree.

    Unbatched only: ms (T + 1, dx), Ps (T + 1, dx, dx) (use
    `ops.sampling.sampling` for batches and for production). `noise`
    ((T + 1, dx) standard normals), if given, replaces the draws from
    `generator`: x_T's row, then x_0's, then each level's midpoints
    root-down, in the order the JAX package's key splits draw them.
    """
    warnings.warn(
        "dnc_sampling is a pedagogical proof-of-concept; use "
        "ops.sampling.sampling(parallel=True) for production.",
        UserWarning,
    )
    if ms.dim() > 2:
        raise ValueError("Batched sampling is not supported here; use ops.sampling.")
    if noise is None:
        noise = torch.randn(ms.shape, generator=generator, dtype=ms.dtype, device=ms.device)

    xs = torch.zeros_like(ms)
    xs[-1] = rvs(ms[-1], safe_cholesky(Ps[-1]), eps=noise[0])
    root, bridges, lefts, mids, rights = _build_tree(ms, Ps, lgssm)

    # x_0 | x_T from the root's composed map.
    E, g, L = root
    xs[0] = rvs(E[0] @ xs[-1] + g[0], safe_cholesky(L[0]), eps=noise[1])

    used = 2
    for (G, Gamma, w, V), i_l, i_m, i_r in zip(bridges, lefts, mids, rights):
        mean = (G @ xs[i_l, :, None] + Gamma @ xs[i_r, :, None])[..., 0] + w
        xs[i_m] = rvs(mean, safe_cholesky(V), eps=noise[used:used + len(i_m)])
        used += len(i_m)
    return xs


def _compose(E1, g1, L1, E2, g2, L2):
    """Compose the backward maps of a left (1) and a right (2) segment, and
    the midpoint's bridge parameters; batched over leading axes."""
    E = E1 @ E2
    g = g1 + (E1 @ g2[..., None])[..., 0]
    L = L1 + E1 @ L2 @ E1.mT

    if L.shape[-1] == 1:
        G = L2 * E1.mT / L
    else:
        G = _pos_solve_t(L, E1 @ L2)
    Gamma = E2 - G @ E
    w = g2 - (G @ g[..., None])[..., 0]
    V = L2 - G @ L @ G.mT
    return E, g, L, G, Gamma, w, V


def _combine(pair_a, pair_b):
    E, g, L, G, Gamma, w, V = _compose(*pair_a, *pair_b)
    return (E, g, L), (G, Gamma, w, V)


def _leaf_maps(m, P, F, Q, b):
    """Backward conditional x_t | x_{t+1} at filtered (m, P); batched over
    leading axes."""
    FP = F @ P
    S = FP @ F.mT + Q
    if m.shape[-1] == 1:
        E = F * P / S
    else:
        E = _pos_solve_t(S, FP)
    g = m - (E @ ((F @ m[..., None])[..., 0] + b)[..., None])[..., 0]
    L = P - E @ FP
    return E, g, L


def _build_tree(ms, Ps, lgssm):
    """The root's composed map and, root-down, each level's bridges with the
    indices of their left ends, midpoints and right ends."""
    T = ms.shape[0] - 1
    elems = _leaf_maps(ms[:-1], Ps[:-1], lgssm.Fs, lgssm.Qs, lgssm.bs)
    spans = np.stack([np.arange(T), np.arange(1, T + 1)], axis=1)

    bridges, lefts, mids, rights = [], [], [], []
    n = T
    while n > 1:
        even = tuple(z[0:2 * (n // 2):2] for z in elems)
        odd = tuple(z[1::2] for z in elems)
        even_spans, odd_spans = spans[0:2 * (n // 2):2], spans[1::2]
        combined, bridge = _combine(even, odd)

        lefts.append(even_spans[:, 0])
        mids.append(even_spans[:, 1])
        rights.append(odd_spans[:, 1])
        bridges.append(bridge)

        new_spans = np.stack([even_spans[:, 0], odd_spans[:, 1]], axis=1)
        if n % 2:   # the odd one out goes up a level unchanged
            combined = tuple(torch.cat([a, z[-1:]]) for a, z in zip(combined, elems))
            new_spans = np.concatenate([new_spans, spans[-1:]], axis=0)

        elems, spans, n = combined, new_spans, (n + 1) // 2

    return elems, bridges[::-1], lefts[::-1], mids[::-1], rights[::-1]
