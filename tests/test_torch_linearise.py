"""The port's linearisation rules (`aux_ssm_tpu_torch.ops.linearise`) and the
rest of its `ops/mvn.py` (`rvs`, `get_optimal_covariance`) against the JAX
package's, on the same callables and inputs in float64: exactness on affine
maps, the nonlinear case of `tests/test_linearise.py`, `params`, and
`extended` under vmap over a trajectory (the Lorenz pattern).

Tolerance: rtol 1e-12 (atol 1e-12 where an entry is zero). Both sides take
the same closed forms (Jacobians by autodiff, sigma points from the same
NumPy construction, one Cholesky solve or eigendecomposition of a 3 x 3
matrix) in other summation orders: they agree to a few ulps, so 1e-12 sees
any wrong term. `get_optimal_covariance` is compared as chol chol^T, which
does not depend on the sign or order of the eigenvectors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aux_ssm_tpu.ops import linearise as jlin  # noqa: E402
from aux_ssm_tpu.ops import mvn as jmvn  # noqa: E402
from aux_ssm_tpu_torch.ops import linearise as tlin  # noqa: E402
from aux_ssm_tpu_torch.ops import mvn as tmvn  # noqa: E402

RULES = ["extended", "cubature", "gauss_hermite"]
TOL = dict(rtol=1e-12, atol=1e-12)


def t64(z):
    return torch.as_tensor(np.array(z), dtype=torch.float64)


def both(rule, jfns, tfns, params, x_star, P_star):
    """(JAX's (F, Q, b), the port's) of `rule` on the two packages' callables."""
    jout = getattr(jlin, rule)(*jfns, params, jnp.asarray(x_star), jnp.asarray(P_star))
    tout = getattr(tlin, rule)(*tfns, params, t64(x_star), t64(P_star))
    return [np.asarray(z) for z in jout], [z.numpy() for z in tout]


@pytest.fixture(scope="module")
def affine():
    rng = np.random.default_rng(0)
    F, b = rng.standard_normal((3, 3)), rng.standard_normal(3)
    Q = np.diag(rng.uniform(0.5, 2.0, 3))
    jfns = (lambda x, _p: jnp.asarray(F) @ x + jnp.asarray(b), lambda x, _p: jnp.asarray(Q))
    tfns = (lambda x, _p: t64(F) @ x + t64(b), lambda x, _p: t64(Q))
    return (F, Q, b), jfns, tfns


@pytest.mark.parametrize("rule", RULES)
def test_exact_on_affine_and_equal_to_jax(affine, rule):
    truth, jfns, tfns = affine
    x_star = np.random.default_rng(1).standard_normal(3)
    want, got = both(rule, jfns, tfns, None, x_star, np.eye(3))
    for g, w, exact in zip(got, want, truth):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, exact, atol=1e-8)


@pytest.mark.parametrize("rule", RULES)
def test_nonlinear_equal_to_jax(rule):
    jfns = (lambda x, _p: jnp.sin(x), lambda x, _p: 0.1 * jnp.eye(2))
    tfns = (lambda x, _p: torch.sin(x), lambda x, _p: 0.1 * torch.eye(2, dtype=torch.float64))
    want, got = both(rule, jfns, tfns, None, np.array([0.3, -0.2]), 0.05 * np.eye(2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    # Small P*: the statistical linearisations approach the Taylor one.
    taylor = both("extended", jfns, tfns, None, np.array([0.3, -0.2]), 0.05 * np.eye(2))[1]
    np.testing.assert_allclose(got[0], taylor[0], atol=5e-2)


def test_gauss_hermite_order_and_params():
    jfns = (lambda x, p: p * jnp.tanh(x), lambda x, p: p * jnp.eye(3))
    tfns = (lambda x, p: p * torch.tanh(x), lambda x, p: p * torch.eye(3, dtype=torch.float64))
    x_star = np.array([0.5, -1.0, 0.2])
    P_star = np.array([[0.3, 0.1, 0.0], [0.1, 0.2, 0.05], [0.0, 0.05, 0.4]])
    jout = jlin.gauss_hermite(*jfns, 2.5, jnp.asarray(x_star), jnp.asarray(P_star), order=5)
    tout = tlin.gauss_hermite(*tfns, 2.5, t64(x_star), t64(P_star), order=5)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    F, Q, b = tlin.extended(lambda x, p: p * x, lambda x, p: torch.eye(2, dtype=torch.float64),
                            3.0, torch.ones(2, dtype=torch.float64))
    np.testing.assert_allclose(F.numpy(), 3.0 * np.eye(2), **TOL)
    np.testing.assert_allclose(b.numpy(), 0.0, **TOL)


def test_extended_wide_map_takes_reverse_mode():
    """A map to fewer outputs than inputs (reverse mode in both packages)."""
    jmean = lambda x, _p: jnp.array([x[0] * x[1] + x[2] ** 2, jnp.exp(x[0]) - x[2]])  # noqa: E731
    tmean = lambda x, _p: torch.stack([x[0] * x[1] + x[2] ** 2, torch.exp(x[0]) - x[2]])  # noqa: E731
    x_star = np.array([0.4, -0.7, 1.3])
    jout = jlin.extended(jmean, lambda x, _p: jnp.eye(2), None, jnp.asarray(x_star))
    tout = tlin.extended(tmean, lambda x, _p: torch.eye(2, dtype=torch.float64), None,
                         t64(x_star))
    assert tout[0].shape == (2, 3)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_extended_vmapped_over_trajectory():
    def jmean(x, _p):
        return x + 0.01 * jnp.array([10 * (x[1] - x[0]), x[0] * (28 - x[2]) - x[1],
                                     x[0] * x[1] - 8 / 3 * x[2]])

    def tmean(x, _p):
        return x + 0.01 * torch.stack([10 * (x[1] - x[0]), x[0] * (28 - x[2]) - x[1],
                                       x[0] * x[1] - 8 / 3 * x[2]])

    xs = np.random.default_rng(2).standard_normal((7, 3))
    want = jax.vmap(lambda x: jlin.extended(jmean, lambda x, p: 0.1 * jnp.eye(3), None, x))(
        jnp.asarray(xs))
    got = torch.func.vmap(lambda x: tlin.extended(
        tmean, lambda x, p: 0.1 * torch.eye(3, dtype=torch.float64), None, x))(t64(xs))
    assert got[0].shape == (7, 3, 3) and got[1].shape == (7, 3, 3) and got[2].shape == (7, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # F x* + b reproduces the mean at each expansion point.
    np.testing.assert_allclose(torch.einsum("tij,tj->ti", got[0], t64(xs)) + got[2],
                               torch.stack([tmean(x, None) for x in t64(xs)]), **TOL)


def test_mvn_rvs_given_jax_normals():
    key = jax.random.key(4)
    m = jnp.array([[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]])
    chol = jnp.array([[2.0, 0.0, 0.0], [1.0, 0.5, 0.0], [-0.3, 0.2, 1.5]])
    want = jmvn.rvs(key, m, chol)
    eps = jax.random.normal(key, m.shape, m.dtype)  # as JAX's rvs draws it
    got = tmvn.rvs(t64(m), t64(chol), eps=t64(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = tmvn.rvs(t64(m), t64(chol), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 3) and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("dim", [1, 3])
def test_optimal_covariance_equal_to_jax(dim):
    rng = np.random.default_rng(3 + dim)
    A, B = rng.standard_normal((dim, dim)), rng.standard_normal((dim, dim))
    chol_P = np.linalg.cholesky(A @ A.T + np.eye(dim))
    chol_S = np.linalg.cholesky(B @ B.T + np.eye(dim))
    want = np.asarray(jmvn.get_optimal_covariance(jnp.asarray(chol_P), jnp.asarray(chol_S)))
    got = tmvn.get_optimal_covariance(t64(chol_P), t64(chol_S)).numpy()
    np.testing.assert_allclose(got @ got.T, want @ want.T, **TOL)
    for M in (chol_P @ chol_P.T, chol_S @ chol_S.T):
        assert np.linalg.eigvalsh(got @ got.T - M).min() > -1e-8


def test_optimal_covariance_scalar_branch():
    got = tmvn.get_optimal_covariance(torch.tensor([0.5, 2.0], dtype=torch.float64),
                                      torch.tensor([1.0, 1.5], dtype=torch.float64))
    want = jmvn.get_optimal_covariance(jnp.array([0.5, 2.0]), jnp.array([1.0, 1.5]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tmvn.get_optimal_covariance(t64(0.3), t64(0.7))) == 0.7
