"""Effective sample size via FFT autocovariance and Geyer's initial monotone
sequence, split-R-hat, and R-hat from moments (counterpart of
`aux_ssm_tpu/utils/ess.py`; Geyer 1992, the Stan reference manual, Vehtari et
al. 2021). Inputs are tensors or anything `torch.as_tensor` takes; results
are tensors on the input's device.
"""
import math

import torch


def _autocovariance_fft(x):
    """Biased autocovariance of (m, n) chains via FFT, all lags."""
    n = x.shape[-1]
    x = x - x.mean(-1, keepdim=True)
    size = 2 * n  # zero padding to avoid circular wrap-around
    f = torch.fft.rfft(x, n=size)
    acov = torch.fft.irfft(f * f.conj(), n=size)[..., :n]
    return acov / n


def effective_sample_size(chains, known_variance=None):
    """ESS of scalar MCMC chains, (n_samples,) or (n_chains, n_samples);
    several chains pool their autocovariances Stan-style. With
    `known_variance`, autocorrelations are normalised by that true variance
    instead of the empirical one. Returns a 0-d tensor."""
    chains = torch.atleast_2d(torch.as_tensor(chains))
    m, n = chains.shape

    acov = _autocovariance_fft(chains)
    mean_acov = acov.mean(0)
    acov0 = acov[:, 0].mean()

    if known_variance is None:
        within = acov0 * n / (n - 1.0)
        if m > 1:
            between = n * chains.mean(1).var(unbiased=True)
            var_plus = within * (n - 1.0) / n + between / n
        else:
            var_plus = within * (n - 1.0) / n + acov0 / n
    else:
        var_plus = torch.as_tensor(known_variance, dtype=chains.dtype, device=chains.device)

    rho = 1.0 - (acov0 - mean_acov) / var_plus
    rho[0] = 1.0

    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}: cut at the first non-positive
    # pair, then force the sequence to be non-increasing.
    n_pairs = n // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    before_cut = torch.cumprod((pairs > 0).to(pairs.dtype), 0)
    monotone = torch.cummin(pairs * before_cut, 0).values
    tau = -1.0 + 2.0 * monotone.sum()
    tau = torch.clamp_min(tau, 1.0 / math.log10(float(m * n)))
    return m * n / tau


def _split_halves(chains):
    """(m, n) -> (2m, n // 2): each chain's first and last halves (the middle
    sample dropped when n is odd)."""
    h = chains.shape[1] // 2
    return torch.cat([chains[:, :h], chains[:, chains.shape[1] - h:]])


def _rhat_of(chains):
    """Basic potential scale reduction of (m, n) chains, m >= 2; +inf for
    all-constant chains (within-chain variance 0)."""
    n = chains.shape[1]
    between = n * chains.mean(1).var(unbiased=True)
    within = chains.var(1, unbiased=True).mean()
    var_plus = within * (n - 1.0) / n + between / n
    safe = torch.where(within > 0.0, within, torch.ones_like(within))
    return torch.where(within > 0.0, torch.sqrt(var_plus / safe),
                       torch.full_like(within, math.inf))


def _rank_normalize(chains):
    """Pooled values to normal quantiles of their fractional ranks, z =
    ndtri((r - 3/8) / (S + 1/4)); ties get the average rank of their group
    (MH chains are full of exact ties from rejections)."""
    flat = chains.reshape(-1)
    S = flat.shape[0]
    sorted_vals, order = torch.sort(flat)
    _, counts = torch.unique_consecutive(sorted_vals, return_counts=True)
    first = torch.cumsum(counts, 0) - counts          # 0-based position of each tie group
    avg_rank = (2 * first + counts - 1).to(torch.float64) / 2.0 + 1.0
    ranks = torch.empty(S, dtype=torch.float64, device=flat.device)
    ranks[order] = torch.repeat_interleave(avg_rank, counts)
    z = torch.special.ndtri((ranks - 0.375) / (S + 0.25)).to(chains.dtype)
    return z.reshape(chains.shape)


def potential_scale_reduction(chains, rank_normalized=True):
    """Split-R-hat of (n_chains, n_samples) scalar chains; with
    `rank_normalized` the larger of the rank-normalised bulk and folded-tail
    statistics (Vehtari et al. 2021), else the classical split-R-hat.
    Returns a 0-d tensor."""
    split = _split_halves(torch.atleast_2d(torch.as_tensor(chains)))
    if not rank_normalized:
        return _rhat_of(split)
    bulk = _rhat_of(_rank_normalize(split))
    folded = (split - torch.quantile(split.reshape(-1), 0.5)).abs()
    return torch.maximum(bulk, _rhat_of(_rank_normalize(folded)))


def rhat_from_moments(chain_means, chain_vars, n):
    """Classical (non-split) R-hat per coordinate from per-chain means and
    variances (n_chains, ...) of `n` samples each; +inf where the
    within-chain variance is 0."""
    chain_means = torch.as_tensor(chain_means)
    W = torch.as_tensor(chain_vars).mean(0)
    B = n * chain_means.var(0, unbiased=True)
    var_plus = W * (n - 1.0) / n + B / n
    safe = torch.where(W > 0.0, W, torch.ones_like(W))
    return torch.where(W > 0.0, torch.sqrt(var_plus / safe), torch.full_like(W, math.inf))
