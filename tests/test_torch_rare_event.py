"""The port's rare-event model against the JAX package's: the closed form,
the exact initial draw, one step of every sampler style given the noise JAX
draws (float64, rtol 1e-9, picked indices and acceptances identical), and in
law, a short chain of each style against the closed-form conditionals.

JAX runs its generic loops here (no TPU); the port takes the scalar scans'
plain versions in the batched scalar layout at M = 1 (kalman), the factor
sweeps (csmc) and the lane sweep (csmc-guided). T = 2, the published grid's
length, is one sweep step.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import rare_event as jre  # noqa: E402
from aux_ssm_tpu_torch import rare_event_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.models import rare_event as tre  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402
from aux_ssm_tpu_torch.utils.ess import effective_sample_size  # noqa: E402

filtering = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")
sampling = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")

Y, RHO, R2 = 5.0, 0.8, 0.5
N = 8
f64 = jnp.float64
CPU = dict(device="cpu", dtype=torch.float64)


def _t(z):
    return torch.as_tensor(np.array(z))


@pytest.mark.parametrize("y,rho,r2,T", [(5.0, 0.8, 0.5, 2), (5.0, 0.999, 1e-3, 2),
                                        (-2.0, 0.3, 0.1, 7), (1.0, 0.0, 1.0, 1)])
def test_conditional_moments_match_jax(y, rho, r2, T):
    assert tre.conditional_moments(y, rho, r2, T) == jre.conditional_moments(y, rho, r2, T)


@pytest.mark.parametrize("T", [2, 6])
@pytest.mark.parametrize("parallel", [False, True])
def test_init_x_matches_jax_given_noise(T, parallel):
    key = jax.random.key(T)
    want = jre.init_x(key, Y, RHO, R2, T, parallel)
    eps = jax.random.normal(key, (T, 1), f64)
    got = tre.init_x(Y, RHO, R2, T, parallel, eps=_t(eps), **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)


def _kalman_noise(key, T):
    aux_key, sample_key, accept_key = jax.random.split(key, 3)
    return (jax.random.normal(aux_key, (T, 1), f64), jax.random.normal(sample_key, (T, 1), f64),
            jax.random.uniform(accept_key, (), f64))


def _csmc_noise(key, T):
    """Every random number of one JAX aux-cSMC step (backward sampling), as
    csmc_aux.py and csmc.py draw them from `key`."""
    aux_key, inner = jax.random.split(key)
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    return (jax.random.normal(aux_key, (T, 1), f64), jax.random.normal(key_init, (N, 1), f64),
            jax.random.uniform(key_res, (T - 1, N), f64),
            jax.random.normal(key_prop, (T - 1, N, 1), f64),
            jax.random.uniform(key_anc, (T - 1,), f64), jax.random.uniform(key_bwd, (T,), f64))


def _kernels(style, T):
    gradient = style.endswith("-grad")
    if style.startswith("kalman"):
        return (jre.get_kalman_kernel(Y, RHO, R2, T, True, gradient=gradient),
                tre.get_kalman_kernel(Y, RHO, R2, T, True, gradient=gradient, **CPU),
                _kalman_noise)
    if style.startswith("csmc-guided"):
        return (jre.get_guided_csmc_kernel(Y, RHO, R2, T, N, backward=True, gradient=gradient),
                tre.get_guided_csmc_kernel(Y, RHO, R2, T, N, backward=True, gradient=gradient,
                                           **CPU), _csmc_noise)
    return (jre.get_csmc_kernel(Y, RHO, R2, T, N, backward=True, gradient=gradient),
            tre.get_csmc_kernel(Y, RHO, R2, T, N, backward=True, gradient=gradient, **CPU),
            _csmc_noise)


@pytest.mark.parametrize("T", [2, 6])
@pytest.mark.parametrize("style", ["kalman", "kalman-grad", "csmc", "csmc-grad", "csmc-guided",
                                   "csmc-guided-grad"])
def test_step_matches_jax_given_noise(monkeypatch, style, T):
    (jinit, jkernel), (tinit, tkernel), draw = _kernels(style, T)
    calls = {"lane": 0, "factor": 0, "filter": 0, "affine": 0}
    for mod, name, key in ((CF, "lane_scan", "lane"), (CF, "forward_factor_scan", "factor"),
                           (filtering, "scalar_filter_scan", "filter"),
                           (sampling, "scalar_affine_scan", "affine")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
    x0 = np.array(jre.init_x(jax.random.key(1), Y, RHO, R2, T))
    delta = np.random.default_rng(T).uniform(0.3, 1.5, T) if "csmc" in style else 0.7
    tx0, tdelta = rare_event_from_numpy(x0, delta, **CPU)
    jstate, tstate = jinit(jnp.asarray(x0)), tinit(tx0)
    jstep = jax.jit(lambda k, s: jkernel(k, s, jnp.asarray(delta)))
    keys = jax.random.split(jax.random.key(11), 3)
    for key in keys:
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, tdelta, noise=tuple(_t(z) for z in draw(key, T)))
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
    n = len(keys)  # kalman: one cell is M = 1 of the scalar scans' batched layout
    want = {"kalman": (0, 0, 2 * n, n), "csmc": (0, n, 0, 0), "csmc-guided": (n, 0, 0, 0)}
    assert (calls["lane"], calls["factor"], calls["filter"],
            calls["affine"]) == want[style.removesuffix("-grad")]


def test_parallel_csmc_is_not_ported(monkeypatch):
    """`parallel=True` was not ported; it is the PIT cSMC now: a step at T=2
    draws its root through row_lse and runs neither sequential sweep."""
    from aux_ssm_tpu_torch.kernels import pit
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd
    calls = []
    row_lse = pit.kernels.row_lse
    monkeypatch.setattr(pit.kernels, "row_lse", lambda *a: calls.append(1) or row_lse(*a))
    for name in ("forward_factor_scan", "backward_factor_scan"):
        monkeypatch.setattr(csmc_fwd, name, lambda *a, **k: pytest.fail("a sequential sweep ran"))
    init, kernel = tre.get_csmc_kernel(Y, RHO, R2, 2, N, parallel=True, **CPU)
    state = kernel(init(torch.full((2, 1), 3.0, dtype=torch.float64)),
                   torch.full((2,), 0.5, dtype=torch.float64),
                   generator=torch.Generator().manual_seed(0))
    assert calls == [1] and state.x.shape == (2, 1) and bool(torch.isfinite(state.x).all())


@pytest.mark.parametrize("style", ["kalman", "kalman-grad", "csmc", "csmc-guided",
                                   "csmc-guided-grad"])
def test_posterior_moments_in_law(style):
    """A short chain at the published grid's T = 2 against the closed form:
    means within 6 Monte-Carlo standard errors (from the ported ESS), standard
    deviations within 15%."""
    T, n_iter = 2, 2500
    _, (init, kernel), _ = _kernels(style, T)
    gen = torch.Generator().manual_seed(3)
    state = init(tre.init_x(Y, RHO, R2, T, generator=gen, **CPU))
    delta = torch.full((T,), 2.0 if "guided" in style else 1.0,
                       dtype=torch.float64) if "csmc" in style else 1.0
    xs = []
    for _ in range(n_iter):
        state = kernel(state, delta, generator=gen)
        xs.append(state.x[:, 0])
    xs = torch.stack(xs[n_iter // 5:])
    (m0c, v0c), (mTc, vTc) = tre.conditional_moments(Y, RHO, R2, T)
    for col, mean, var in ((0, m0c, v0c), (-1, mTc, vTc)):
        chain = xs[:, col]
        ess = float(effective_sample_size(chain, known_variance=var))
        assert ess > 20, ess
        assert abs(float(chain.mean()) - mean) < 6 * np.sqrt(var / ess)
        np.testing.assert_allclose(float(chain.std()), np.sqrt(var), rtol=0.15)
