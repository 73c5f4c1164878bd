"""Online chain statistics: EJSD, moments, acceptance rates (counterpart of
`aux_ssm_tpu/utils/stats.py`)."""
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OnlineStats:
    """Running statistics of the sampling loop.

    ejsd       running mean of (x_{k+1} - x_k)^2, per trajectory element
    mean_x     running mean of x
    mean_x2    running mean of x^2
    accept_cum cumulative mean acceptance rate, in the shape of the kernel's
               `updated` (a scalar for MH, (T,) for cSMC: per-step rates
               drive time-local delta adaptation)
    accept_win beta-EMA (windowed) acceptance rate, same shape
    step       iteration count: a scalar, or (C,) for C chains on a leading
               axis of every other field (`parallel.chains`)
    """
    ejsd: torch.Tensor
    mean_x: torch.Tensor
    mean_x2: torch.Tensor
    accept_cum: torch.Tensor
    accept_win: torch.Tensor
    step: torch.Tensor


def init_stats(x0, accept_shape=(), step_shape=()):
    """Zero statistics for states like `x0`; `step_shape` (C,) for C chains."""
    z = torch.zeros_like(x0)
    kw = dict(dtype=x0.dtype, device=x0.device)
    return OnlineStats(ejsd=z, mean_x=z, mean_x2=z, accept_cum=torch.zeros(accept_shape, **kw),
                       accept_win=torch.zeros(accept_shape, **kw),
                       step=torch.zeros(step_shape, dtype=torch.int32, device=x0.device))


def _leading(k, like):
    """The step count `k` (a scalar, or (C,) per chain) aligned with the
    leading axes of `like`."""
    return k.reshape(tuple(k.shape) + (1,) * (like.dim() - k.dim()))


def update_stats(stats, x_prev, x_new, accepted, beta=0.05, weight=None):
    """One online update; `accepted` keeps its shape in the acceptance
    statistics; `beta` is the EMA window rate. A (C,) step count divides
    each chain's leading-axis slice by its own count."""
    k = stats.step + 1
    fk = k.to(stats.mean_x.dtype)
    rate = accepted.to(stats.mean_x.dtype) if weight is None else weight
    jump2 = (x_new - x_prev) ** 2
    fx, fa = _leading(fk, stats.mean_x), _leading(fk, stats.accept_cum)
    return OnlineStats(
        ejsd=stats.ejsd + (jump2 - stats.ejsd) / fx,
        mean_x=stats.mean_x + (x_new - stats.mean_x) / fx,
        mean_x2=stats.mean_x2 + (x_new ** 2 - stats.mean_x2) / fx,
        accept_cum=stats.accept_cum + (rate - stats.accept_cum) / fa,
        accept_win=torch.where(_leading(k, stats.accept_win) == 1, rate,
                               (1 - beta) * stats.accept_win + beta * rate),
        step=k,
    )


def variance(stats):
    """Posterior variance estimate from the accumulated moments."""
    return stats.mean_x2 - stats.mean_x ** 2
