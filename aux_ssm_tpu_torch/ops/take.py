"""Batched row gathers and inverse-CDF categorical draws (counterpart of
`aux_ssm_tpu/ops/take.py`, in law).

The JAX package replaces gathers and `searchsorted` by one-hot matrix
products and tile CDFs on a TPU, whose gathers are slow; on a CPU it takes
the flat inverse CDF below. Here a gather is `torch.gather` and a draw is
`torch.cumsum` + `torch.searchsorted`, on every device: the same values as
the JAX package's CPU path.
"""
import torch


def take_rows(vals, idx):
    """Batched `vals[..., idx, :]` along the second-to-last axis (or the last,
    for vals (..., N) and idx (..., n)). Exact."""
    if vals.dim() == idx.dim():
        return torch.gather(vals, -1, idx)
    index = idx[..., None].expand(*idx.shape, vals.shape[-1])
    return torch.gather(vals, -2, index)


def categorical_from_uniforms(logits, u):
    """n iid inverse-CDF draws over N from unnormalised log-probs: logits
    (..., N), u (..., n) uniforms in (0, 1) -> (..., n) int64. The index of a
    uniform is #{i : cdf[i] < u * total} (`jnp.searchsorted`'s side='left'),
    clipped to N - 1."""
    m = logits.amax(-1, keepdim=True)
    cdf = torch.cumsum(torch.exp(logits - m), -1)
    target = (u * cdf[..., -1:]).contiguous()
    return torch.searchsorted(cdf.contiguous(), target).clamp_(0, logits.shape[-1] - 1)
