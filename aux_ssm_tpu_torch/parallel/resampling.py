"""Conditional resampling over a sharded particle axis (counterpart of
`aux_ssm_tpu/parallel/resampling.py`).

The draw runs on the all-gathered weights (N values), replicated, so the
indices are those of the one-device scheme on the same uniforms, global
index 0 pinned to 0; each shard then takes its own N/S of them. The
particles come from the all-gathered particles, or, in the streaming
variant, from the blocks that rotate past each shard by `ppermute` (two
local blocks at a time at most). Both are bit-equal to the one-device
`scheme_from_uniforms(u, w)` and take.

The functions take whole tensors (every process the same) and return whole
tensors; each process works on its own shards only.
"""
import torch

from . import collectives as col
from .mesh import PARTICLES
from ..ops import resampling as rs

_FROM_UNIFORMS = {"multinomial": (rs.multinomial_from_uniforms, None),
                  "systematic": (rs.systematic_from_uniforms, 3)}


def scheme_noise(scheme, N, like, generator=None):
    """The uniforms of one draw of `scheme` ('multinomial': (N,),
    'systematic': (3,)) from `generator`."""
    n = _FROM_UNIFORMS[scheme][1] or N
    return torch.rand(n, generator=generator, dtype=like.dtype, device=like.device)


def _draw(mesh, scheme, u, w_parts, axis):
    """Each local shard's N/S of the indices drawn from the all-gathered
    weights (replicated: once a process, on its first shard device)."""
    if scheme not in _FROM_UNIFORMS:
        raise ValueError(f"unknown resampling scheme: {scheme!r}")
    w = col.gather(mesh, w_parts, 0, axis)
    idx = _FROM_UNIFORMS[scheme][0](u.to(w.device), w)
    n = w_parts[0].shape[0]
    return [idx[s * n:(s + 1) * n].to(p.device)
            for s, p in zip(col.axis_index(mesh, axis), w_parts)]


def sharded_conditional_resample(mesh, weights, particles, noise, scheme="multinomial",
                                 axis=PARTICLES):
    """Resample `particles` (N, ...) by the global `weights` (N,), index 0
    pinned, with the particle axis over `mesh[axis]`; `noise` the scheme's
    uniforms (`scheme_noise`). Bit-equal to the one-device draw and take."""
    w_parts = col.split(mesh, weights, 0, axis)
    p_all = col.all_gather(mesh, col.split(mesh, particles, 0, axis), 0, axis)
    mine = _draw(mesh, scheme, noise, w_parts, axis)
    return col.gather(mesh, [p[i] for p, i in zip(p_all, mine)], 0, axis)


def sharded_conditional_resample_streaming(mesh, weights, particles, noise,
                                           scheme="multinomial", axis=PARTICLES):
    """`sharded_conditional_resample` without all-gathering the particles:
    each shard's block travels round the ring by `ppermute`, and each shard
    picks the rows it needs as the blocks go past, holding two blocks at a
    time. The weights are still all-gathered, so the indices, and the
    result, are the same bits."""
    S = mesh.shape[axis]
    perm = [(j, (j + 1) % S) for j in range(S)]
    w_parts = col.split(mesh, weights, 0, axis)
    buf = col.split(mesh, particles, 0, axis)
    mine = _draw(mesh, scheme, noise, w_parts, axis)
    n = buf[0].shape[0]
    out = [torch.zeros_like(b) for b in buf]
    for r in range(S):
        for i, s in enumerate(col.axis_index(mesh, axis)):
            owner = (s - r) % S                  # whose block shard s holds now
            need = mine[i]
            here = (need // n) == owner
            out[i][here] = buf[i][need[here] % n]
        if r + 1 < S:
            buf = col.ppermute(mesh, buf, perm, axis)
    return col.gather(mesh, out, 0, axis)


def sharded_normalize(mesh, log_weights, axis=PARTICLES):
    """Exp-normalised log weights (N,) with the particle axis over
    `mesh[axis]`: the global max by `pmax`, the global sum by `psum`."""
    parts = col.split(mesh, log_weights, 0, axis)
    m = col.pmax(mesh, [p.max() for p in parts], axis)
    s = col.psum(mesh, [torch.exp(p - mi).sum() for p, mi in zip(parts, m)], axis)
    return col.gather(mesh, [torch.exp(p - mi) / si for p, mi, si in zip(parts, m, s)], 0, axis)
