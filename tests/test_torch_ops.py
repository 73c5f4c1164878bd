"""The port's ops (`aux_ssm_tpu_torch.ops`) against the JAX package's
(`aux_ssm_tpu.ops`), given the same float64 inputs and the same noise.

Tolerance: float64 on both sides, same algebra, other summation and
association orders (the port scans in its kernel's chunk order, JAX with
`associative_scan`); agreement is ~1e-12, and rtol 1e-9 catches any wrong
term. Sampling goes through the jittered Cholesky of nearly singular
backward covariances, which amplifies rounding: rtol 1e-7 there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops import lgssm as jl  # noqa: E402
from aux_ssm_tpu.ops import mvn as jmvn  # noqa: E402
from aux_ssm_tpu.ops.chol import safe_cholesky as j_safe_cholesky  # noqa: E402
from aux_ssm_tpu_torch.ops import lgssm as tl  # noqa: E402
from aux_ssm_tpu_torch.ops import mvn as tmvn  # noqa: E402
from aux_ssm_tpu_torch.ops.chol import safe_cholesky  # noqa: E402
from aux_ssm_tpu_torch.ops.filtering import filtering  # noqa: E402
from aux_ssm_tpu_torch.ops.sampling import sampling  # noqa: E402

JF = importlib.import_module("aux_ssm_tpu.ops.filtering")
JS = importlib.import_module("aux_ssm_tpu.ops.sampling")


def _model(T, dx, dy, seed, nan_frac=0.0):
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = random_lgssm(rng, T, dx, dy)
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    j = (jl.LGSSM(*map(jnp.asarray, params)), jnp.asarray(ys))
    t = (tl.LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys))
    return j, t


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("T,dx,dy,nan_frac", [(40, 3, 2, 0.0), (60, 2, 3, 0.3),
                                              (30, 1, 1, 0.2)])
def test_filtering_matches_jax(parallel, T, dx, dy, nan_frac):
    (jlg, jys), (tlg, tys) = _model(T, dx, dy, seed=T + dx, nan_frac=nan_frac)
    want = JF.filtering(jys, jlg, parallel)
    got = filtering(tys, tlg, parallel)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("T,dx,dy", [(40, 3, 2), (25, 1, 1)])
def test_sampling_matches_jax_given_noise(parallel, T, dx, dy):
    import jax
    (jlg, jys), (tlg, tys) = _model(T, dx, dy, seed=7)
    ms, Ps, _ = JF.filtering(jys, jlg, parallel)
    key = jax.random.key(3)
    eps = jax.random.normal(key, ms.shape, ms.dtype)  # what JS.sampling draws
    want = JS.sampling(key, ms, Ps, jlg, parallel)
    got = sampling(torch.as_tensor(np.array(eps)), torch.as_tensor(np.array(ms)),
                   torch.as_tensor(np.array(Ps)), tlg, parallel)
    _close(got, want, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(30, 3, 2, 0.0), (50, 2, 3, 0.4), (20, 1, 1, 0.0)])
def test_densities_match_jax(T, dx, dy, nan_frac):
    (jlg, jys), (tlg, tys) = _model(T, dx, dy, seed=11, nan_frac=nan_frac)
    xs = np.random.default_rng(12).standard_normal((T, dx))
    jx, tx = jnp.asarray(xs), torch.as_tensor(xs)
    _close(tl.trajectory_logdensity(tys, tx, tlg), jl.trajectory_logdensity(jys, jx, jlg))
    _close(tl.log_likelihood(tys, tx, tlg), jl.log_likelihood(jys, jx, jlg))
    _close(tl.prior_logpdf(tx, tlg), jl.prior_logpdf(jx, jlg))
    _close(tl.posterior_logpdf(tys, tx, torch.tensor(1.5, dtype=torch.float64), tlg),
           jl.posterior_logpdf(jys, jx, 1.5, jlg))
    _close(tl.make_target_logpdf(tys, tlg)(tx), jl.make_target_logpdf(jys, jlg)(jx))


def test_mvn_and_safe_cholesky_match_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((5, 4, 4))
    cov = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(4)
    chol = np.linalg.cholesky(cov)
    x, m = rng.standard_normal((5, 4)), rng.standard_normal(4)
    _close(tmvn.logpdf(torch.as_tensor(x), torch.as_tensor(m), torch.as_tensor(chol)),
           jmvn.logpdf(x, m, chol))
    # Unbatched factor, batched points (the stacked-solve path).
    _close(tmvn.logpdf(torch.as_tensor(x), torch.as_tensor(m), torch.as_tensor(chol[0])),
           jmvn.logpdf(x, m, chol[0]))
    # Rank-deficient covariance: jitter, and a zeroed factor where it fails.
    v = rng.standard_normal((3, 4, 1))
    singular = v @ np.swapaxes(v, -1, -2)
    singular[1] = -np.eye(4)
    _close(safe_cholesky(torch.as_tensor(singular)), j_safe_cholesky(jnp.asarray(singular)),
           rtol=1e-6, atol=1e-8)
