"""The port's post-run analysis and profiling helpers
(`aux_ssm_tpu_torch/utils/{analysis,profiling}.py`): the four analysis
functions against the JAX package's on the same NumPy inputs (AR(1) chains
with MH-style repeats), and the timers and the trace on the CPU.

Tolerance: rtol 1e-12, float64 on both sides.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.utils import analysis as janalysis  # noqa: E402
from aux_ssm_tpu_torch.utils import analysis, profiling  # noqa: E402

RTOL = 1e-12


def _chains(n_chains, n, T, d, phi=0.7, seed=0):
    """AR(1) trajectories (n_chains, n, T, d) with about a third of the
    draws repeated, as a rejecting MH chain repeats them."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((n_chains, n, T, d))
    x = np.empty_like(eps)
    x[:, 0] = eps[:, 0]
    for k in range(1, n):
        x[:, k] = phi * x[:, k - 1] + eps[:, k]
    keep = rng.uniform(size=(n_chains, n)) < 0.66
    keep[:, 0] = True
    idx = np.maximum.accumulate(np.where(keep, np.arange(n), 0), axis=1)
    return np.take_along_axis(x, idx[:, :, None, None], axis=1) + np.arange(T)[:, None]


def _same_dict(got, want):
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=RTOL)


def test_ejsd_per_time_and_moment_errors_match_jax():
    rng = np.random.default_rng(1)
    ejsd = rng.uniform(0.1, 1.0, (16, 3))
    np.testing.assert_allclose(analysis.ejsd_per_time(ejsd, 3.7, 900),
                               janalysis.ejsd_per_time(ejsd, 3.7, 900), rtol=RTOL)
    args = (rng.standard_normal(8), rng.uniform(0.5, 2, 8), rng.standard_normal(8),
            rng.uniform(0.5, 2, 8))
    for got, want in zip(analysis.moment_errors(*args), janalysis.moment_errors(*args)):
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("coords, known", [(None, None), ([(0, 1), (5, 0)], 2.0)])
def test_ess_summary_matches_jax(coords, known):
    s = _chains(1, 500, 9, 2)[0]
    _same_dict(analysis.ess_summary(s, coords, known), janalysis.ess_summary(s, coords, known))


@pytest.mark.parametrize("rank_normalized", [True, False])
def test_rhat_summary_matches_jax(rank_normalized):
    s = _chains(4, 300, 8, 2, seed=2)
    _same_dict(analysis.rhat_summary(s, rank_normalized=rank_normalized),
               janalysis.rhat_summary(s, rank_normalized=rank_normalized))
    with pytest.raises(ValueError, match="n_chains"):
        analysis.rhat_summary(s[0])


def test_timers_and_trace_on_cpu(tmp_path):
    x = torch.ones(64, dtype=torch.float64)
    with profiling.timer("matmul", sync={"out": x}) as box:
        y = torch.outer(x, x).sum()
    assert box["label"] == "matmul" and box["seconds"] >= 0.0 and float(y) == 64 * 64
    assert profiling.timeit_ms(torch.outer, x, x, n_iter=3) >= 0.0
    profiling.fence((None, [x]))           # CPU: nothing to wait for
    assert profiling.first_tensor({"a": 1, "b": (None, x)}) is x
    with profiling.trace(tmp_path / "trace"):
        torch.outer(x, x).sum()
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
