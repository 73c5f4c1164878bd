"""Effective sample size: Geyer's initial monotone sequence over an FFT
autocovariance, several chains pooled Stan-style (Geyer 1992; the Stan
reference manual), in NumPy float64; and the interior coordinates whose
mean ESS the benchmark reports (the middle half of time, strided to 16
steps, then up to 64 evenly spread (t, i) pairs)."""
import math

import numpy as np


def effective_sample_size(chains):
    """ESS of scalar chains (n_chains, n_samples)."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    m, n = chains.shape
    centred = chains - chains.mean(1, keepdims=True)
    f = np.fft.rfft(centred, n=2 * n)
    acov = np.fft.irfft(f * np.conj(f), n=2 * n)[:, :n] / n
    mean_acov = acov.mean(0)
    acov0 = acov[:, 0].mean()
    within = acov0 * n / (n - 1.0)
    if m > 1:
        var_plus = within * (n - 1.0) / n + chains.mean(1).var(ddof=1)
    else:
        var_plus = within * (n - 1.0) / n + acov0 / n
    if not var_plus > 0:  # every chain constant and all alike: no ESS
        return float("nan")
    rho = 1.0 - (acov0 - mean_acov) / var_plus
    rho[0] = 1.0
    n_pairs = n // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    monotone = np.minimum.accumulate(pairs * np.cumprod(pairs > 0))
    tau = max(-1.0 + 2.0 * monotone.sum(), 1.0 / math.log10(m * n))
    return m * n / tau


def interior_coords(T, d, count=64):
    """[(t, i)] of `count` interior coordinates of a (T, d) trajectory."""
    stride = max(1, (T // 2) // 16)
    times = list(range(T // 4, 3 * T // 4, stride))
    flat = np.unique(np.linspace(0, len(times) * d - 1, count).astype(int))
    return [[times[k // d], int(k % d)] for k in flat]


def mean_ess(samples):
    """Mean over coordinates of the pooled ESS of samples (C, n, K)."""
    return float(np.mean([effective_sample_size(samples[:, :, k])
                          for k in range(samples.shape[-1])]))
