"""`aux_ssm_tpu_torch/utils/ess.py` against `aux_ssm_tpu/utils/ess.py` on
AR(1) chains made with numpy: ESS (one chain, pooled chains, known variance),
split-R-hat (rank-normalised and classical, with exact ties as MH chains have
them) and R-hat from moments, float64, rtol 1e-10 (the same estimator; the
FFTs and `ndtri` of the two libraries differ in the last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.utils import ess as jess  # noqa: E402
from aux_ssm_tpu_torch.utils import ess as tess  # noqa: E402


def _ar1(phi, m, n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((m, n))
    eps = rng.standard_normal((m, n))
    x[:, 0] = eps[:, 0] / np.sqrt(1 - phi ** 2)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x


def _sticky(x, seed):
    """Repeat about half of the draws, as a rejecting MH chain does."""
    keep = np.random.default_rng(seed).uniform(size=x.shape) < 0.5
    keep[:, 0] = True
    idx = np.maximum.accumulate(np.where(keep, np.arange(x.shape[1]), 0), axis=1)
    return np.take_along_axis(x, idx, axis=1)


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.95, -0.6])
@pytest.mark.parametrize("m,n", [(1, 1000), (4, 501), (8, 64)])
def test_effective_sample_size_matches_jax(phi, m, n):
    x = _ar1(phi, m, n, seed=n)
    _close(tess.effective_sample_size(torch.as_tensor(x)), jess.effective_sample_size(x))
    var = 1.0 / (1.0 - phi ** 2)
    _close(tess.effective_sample_size(x, known_variance=var),
           jess.effective_sample_size(x, known_variance=var))
    if m == 1:
        _close(tess.effective_sample_size(torch.as_tensor(x[0])),
               jess.effective_sample_size(x[0]))


def test_effective_sample_size_is_sane():
    x = _ar1(0.9, 1, 20000, seed=0)[0]
    ess = float(tess.effective_sample_size(x))
    assert 0.5 < ess / (20000 * (1 - 0.9) / (1 + 0.9)) < 2.0
    assert float(tess.effective_sample_size(np.random.default_rng(1).standard_normal(4000))) > 3000


@pytest.mark.parametrize("rank_normalized", [True, False])
@pytest.mark.parametrize("phi,m,n,sticky", [(0.5, 4, 400, False), (0.9, 8, 301, True),
                                            (0.0, 2, 50, True)])
def test_potential_scale_reduction_matches_jax(phi, m, n, sticky, rank_normalized):
    x = _ar1(phi, m, n, seed=m)
    if sticky:
        x = _sticky(x, seed=n)
    x[0] += 0.5  # one chain off the others: R-hat above 1
    got = tess.potential_scale_reduction(torch.as_tensor(x), rank_normalized)
    _close(got, jess.potential_scale_reduction(x, rank_normalized))
    assert float(got) > 1.0


def test_rhat_of_stuck_chains_is_inf():
    assert float(tess.potential_scale_reduction(np.ones((4, 20)), False)) == np.inf


def test_rhat_from_moments_matches_jax():
    rng = np.random.default_rng(5)
    means, variances = rng.standard_normal((6, 3, 2)), rng.uniform(0.5, 2.0, (6, 3, 2))
    variances[:, 0, 0] = 0.0  # a stuck coordinate
    got = tess.rhat_from_moments(torch.as_tensor(means), torch.as_tensor(variances), 500)
    want = np.asarray(jess.rhat_from_moments(means, variances, 500))
    assert got[0, 0] == np.inf and want[0, 0] == np.inf
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-10)
