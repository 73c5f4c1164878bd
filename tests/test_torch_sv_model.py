"""The pieces of the port's stochastic-volatility model against the JAX
package's: dynamics, potentials, Hessian diagonal, Feynman–Kac components,
the guided factory's per-step parameters and gradient shift, the
trajectory density and its gradient, `init_x_fn` given JAX's draws, and the
data converter. Float64, rtol 1e-12 where the algebra is the same in other
association orders (1e-10 to 1e-11 through eigenbasis rotations, autograd
and the bootstrap filter's long sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import csmc_independent as jind  # noqa: E402
from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu_torch import sv_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc_independent as tind  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402

NU, PHI, TAU, RHO = 0.0, 0.9, 2.0, 0.25
T, D, N = 16, 4, 8
f64 = jnp.float64


def _t(z):
    return torch.as_tensor(np.array(z))


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    xs, ys = jsv.get_data(jax.random.key(0), NU, PHI, TAU, RHO, D, T)
    return np.array(xs), np.array(ys)


def _eig():
    _, _, _, Q, _ = jsv.get_dynamics(NU, PHI, TAU, RHO, D)
    return tuple(np.array(z) for z in jnp.linalg.eigh(Q)) * 2  # P0 = Q


def test_dynamics_potentials_and_hessian_match_jax(data):
    xs, ys = data
    for got, want in zip(tsv.get_dynamics(NU, PHI, TAU, RHO, D, device="cpu"),
                         jsv.get_dynamics(NU, PHI, TAU, RHO, D)):
        _close(got, want)
    x = np.random.default_rng(0).standard_normal((T, D))
    _close(float(tsv.log_potential(_t(x), _t(ys))), float(jsv.log_potential(x, ys)))
    _close(tsv.hess_log_potential_diag(_t(x), _t(ys)), jsv.hess_log_potential_diag(x, ys),
           rtol=1e-10)


def test_feynman_kac_components_match_jax(data):
    _, ys = data
    jM0, jG0, jMt, jGt = jsv.get_feynman_kac(jnp.asarray(ys), NU, PHI, TAU, RHO)
    tM0, tG0, tMt, tGt = tsv.get_feynman_kac(_t(ys), NU, PHI, TAU, RHO)
    rng = np.random.default_rng(1)
    x, x_next, eps = rng.standard_normal((3, N, D))
    _close(tM0.logpdf(_t(x)), jM0.logpdf(x))
    _close(tG0(_t(x)), jG0(x))
    t = 5
    _close(tMt.sample_from_noise(_t(eps), _t(x), None), jMt.sample_from_noise(eps, x, None))
    _close(tMt.logpdf(_t(x_next), _t(x), None), jMt.logpdf(x_next, x, None))
    _close(tGt(_t(x_next), _t(x), _t(ys[t + 1])), jGt(x_next, x, ys[t + 1]))
    # The port's pair factors are centred (another gauge): their scores agree.
    rf, cf, rb, cb = (z.numpy() for z in tMt.logpdf_factors(_t(x), _t(x_next), None))
    jrf, jcf, jrb, jcb = (np.asarray(z) for z in jMt.logpdf_factors(x, x_next, None))
    _close(rb[:, None] + cb[None] + rf @ cf.T, jrb[:, None] + jcb[None] + jrf @ jcf.T)


@pytest.mark.parametrize("gradient", [False, True])
def test_guided_factory_matches_jax(data, gradient):
    _, ys = data
    rng = np.random.default_rng(2)
    u = rng.standard_normal((T, D))
    scale = rng.uniform(0.2, 0.6, size=T)
    jfac, _ = jsv.make_guided_factory(jnp.asarray(ys), NU, PHI, TAU, RHO, gradient)
    tfac, _ = tsv.make_guided_factory(_t(ys), NU, PHI, TAU, RHO, gradient, eig=_eig())
    jM0, jG0, jMt, jGt = jfac(jnp.asarray(u), jnp.asarray(scale))
    tM0, tG0, tMt, tGt = tfac(_t(u), _t(scale))
    for g, w in zip(tMt.params, jMt.params):  # u, scale, y, rotS, g, sqrtL, inv_sqrtL, hld
        _close(g, w, rtol=1e-11)
    x, x_next, eps = rng.standard_normal((3, N, D))
    key = jax.random.key(3)  # GuidedM0.sample draws normal(key, (N, d))
    _close(tM0.sample_from_noise(_t(jax.random.normal(key, (N, D)))), jM0.sample(key, N),
           rtol=1e-11)
    _close(tM0.logpdf(_t(x)), jM0.logpdf(x), rtol=1e-11)
    _close(tG0(_t(x)), jG0(x), rtol=1e-11)
    pt = jax.tree.map(lambda z: z[3], jMt.params)
    _close(tMt.sample_from_noise(_t(eps), _t(x), tuple(p[3] for p in tMt.params)),
           jMt.sample_from_noise(eps, x, pt), rtol=1e-11)
    _close(tGt(_t(x_next), _t(x), tuple(p[3] for p in tGt.params)),
           jGt(x_next, x, pt), rtol=1e-11)


def test_trajectory_logpdf_and_gradient_match_jax(data):
    _, ys = data
    jfk = jsv.get_feynman_kac(jnp.asarray(ys), NU, PHI, TAU, RHO)
    tfk = tsv.get_feynman_kac(_t(ys), NU, PHI, TAU, RHO)
    u = np.random.default_rng(4).standard_normal((T, D))
    _close(float(tind.trajectory_logpdf(_t(u), *tfk)), float(jind.trajectory_logpdf(u, *jfk)))
    v = _t(u).requires_grad_(True)
    (g,) = torch.autograd.grad(tind.trajectory_logpdf(v, *tfk), v)
    _close(g, jax.grad(jind.trajectory_logpdf)(jnp.asarray(u), *jfk), rtol=1e-10)


def test_init_x_fn_matches_jax_given_its_draws(data):
    _, ys = data
    Np = 32
    key = jax.random.key(5)
    want = jsv.init_x_fn(key, jnp.asarray(ys), NU, PHI, TAU, RHO, Np)
    init_key, fwd_key, bwd_key = jax.random.split(key, 3)
    step_keys = jax.random.split(fwd_key, T)
    k_init, k_loop = jax.random.split(bwd_key)
    noise = (jax.random.normal(init_key, (Np, D)),
             jnp.stack([jax.random.uniform(jax.random.split(k)[0]) for k in step_keys]),
             jnp.stack([jax.random.normal(jax.random.split(k)[1], (Np, D)) for k in step_keys]),
             jax.random.uniform(k_init, (), f64),
             jnp.stack([jax.random.uniform(k, (), f64)
                        for k in jax.random.split(k_loop, T - 1)]))
    got = tsv.init_x_fn(_t(ys), NU, PHI, TAU, RHO, Np, noise=tuple(_t(z) for z in noise))
    _close(got, want, rtol=1e-10, atol=1e-12)
    drawn = tsv.init_x_fn(_t(ys), NU, PHI, TAU, RHO, Np,
                          generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (T, D) and bool(torch.isfinite(drawn).all())


def test_get_data_law_and_sv_from_numpy():
    phi, tau, rho = 0.9, 2.0, 0.25
    xs, ys = tsv.get_data(NU, phi, tau, rho, 3, 4000, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    _, _, F, Q, b = tsv.get_dynamics(NU, phi, tau, rho, 3, device="cpu")
    resid = (xs[1:] - xs[:-1] @ F.T - b).numpy()
    np.testing.assert_allclose(np.cov(resid.T), Q.numpy(), atol=0.25)  # ~5 SE at n = 4000
    z = (ys / torch.exp(0.5 * xs)).numpy()
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1) < 0.05
    for dtype in (torch.float32, torch.float64):
        y, x = sv_from_numpy(ys.numpy(), xs.numpy(), device="cpu", dtype=dtype)
        assert y.dtype == x.dtype == dtype
        np.testing.assert_array_equal(y.numpy(), ys.numpy().astype(y.numpy().dtype))
    assert sv_from_numpy(ys.numpy(), device="cpu", dtype=torch.float64)[1] is None


