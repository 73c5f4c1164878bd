"""Post-run analysis (counterpart of `aux_ssm_tpu/utils/analysis.py`):
EJSD per unit time, normalised moment errors, ESS and split-R-hat summaries
at chosen trajectory coordinates. Inputs are NumPy arrays or anything
`np.asarray` takes; results are NumPy values and Python floats.
"""
import numpy as np

from .ess import effective_sample_size, potential_scale_reduction


def _quartile_coords(T):
    return [(T // 4, 0), (T // 2, 0), (3 * T // 4, 0)]


def ejsd_per_time(ejsd, sampling_time, n_samples):
    """EJSD divided by the wall-clock time per iteration, the paper's
    efficiency statistic."""
    time_per_iter = sampling_time / n_samples
    return np.asarray(ejsd) / time_per_iter


def moment_errors(sample_mean, sample_std, true_mean, true_std):
    """Normalised moment errors: the squared mean error in units of the true
    variance, and the relative error of the standard deviation."""
    true_var = np.asarray(true_std) ** 2
    err_mean = (np.asarray(sample_mean) - np.asarray(true_mean)) ** 2 / true_var
    err_std = (np.asarray(sample_std) - np.asarray(true_std)) / np.asarray(true_std)
    return err_mean, err_std


def ess_summary(samples, coords=None, known_variance=None):
    """ESS at trajectory coordinates of a (n_samples, T, d) chain: {(t, dim):
    ess}; `coords` defaults to the quartile points of the first dimension."""
    s = np.asarray(samples)
    if coords is None:
        coords = _quartile_coords(s.shape[1])
    return {(t, d): float(effective_sample_size(s[:, t, d], known_variance))
            for t, d in coords}


def rhat_summary(samples, coords=None, rank_normalized=True):
    """Split-R-hat at trajectory coordinates of a (n_chains, n_samples, T, d)
    stack: {(t, dim): rhat}; `coords` defaults to the quartile points of the
    first dimension. Mixed chains give values under 1.01."""
    s = np.asarray(samples)
    if s.ndim != 4:
        raise ValueError("rhat_summary expects (n_chains, n_samples, T, d); "
                         f"got shape {s.shape}. Single-chain runs cannot "
                         "compute a between-chain diagnostic.")
    if coords is None:
        coords = _quartile_coords(s.shape[2])
    return {(t, d): float(potential_scale_reduction(s[:, :, t, d],
                                                    rank_normalized=rank_normalized))
            for t, d in coords}
