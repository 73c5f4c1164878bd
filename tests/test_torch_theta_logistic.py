"""The port's theta-logistic model and its whole PGAS step against the JAX
package's, given the noise JAX draws.

JAX runs with AUX_SSM_FUSED_CSMC="0" (its generic forward and backward loops)
or "xla" (its lane oracle and fused backward algebra on the CPU); the port
always takes the lane sweep (and the backward factor sweep). Given the same
noise the picked indices are identical and the states agree to rtol 1e-9 in
float64. JAX's lane oracle rounds the per-step params (the observations) to
float32, so the data are values float32 holds exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import theta_logistic as jtl  # noqa: E402
from aux_ssm_tpu_torch import theta_logistic_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.models import theta_logistic as ttl  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402

T, N = 12, 16
f64 = jnp.float64


def _t(z):
    return torch.as_tensor(np.array(z))


@pytest.fixture(scope="module")
def data():
    xs, ys = jtl.get_data(jax.random.key(0), T)
    return np.array(xs), np.asarray(ys, np.float32).astype(np.float64)


def _jax_step_noise(key, backward):
    """Every random number of one JAX cSMC step, as kernels/csmc.py draws
    them from `key`."""
    key_fwd, key_bwd = jax.random.split(key)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    if backward:
        us = jax.random.uniform(key_bwd, (T,), f64)
    else:  # ancestor scanning: jax.random.choice's one uniform
        us = jnp.zeros(T, f64).at[-1].set(jax.random.uniform(key_bwd, (), f64))
    return (jax.random.normal(key_init, (N, 1), f64),
            jax.random.uniform(key_res, (T - 1, N), f64),
            jax.random.normal(key_prop, (T - 1, N, 1), f64),
            jax.random.uniform(key_anc, (T - 1,), f64), us)


@pytest.mark.parametrize("mode", ["0", "xla"])
@pytest.mark.parametrize("ancestor_sampling", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_pgas_step_matches_jax_given_noise(data, monkeypatch, mode, ancestor_sampling,
                                           backward):
    xs_true, ys = data
    monkeypatch.setenv("AUX_SSM_FUSED_CSMC", mode)
    jinit, jkernel = jtl.get_pgas_kernel(jnp.asarray(ys), N, backward=backward,
                                         ancestor_sampling=ancestor_sampling)
    tys, txs = theta_logistic_from_numpy(ys, xs_true, device="cpu", dtype=torch.float64)
    tinit, tkernel = ttl.get_pgas_kernel(tys, N, backward=backward,
                                         ancestor_sampling=ancestor_sampling)
    calls = []
    lane_scan = CF.lane_scan
    monkeypatch.setattr(CF, "lane_scan", lambda *a: calls.append(a[2]) or lane_scan(*a))
    jstep = jax.jit(jkernel)
    jstate, tstate = jinit(jnp.asarray(xs_true)), tinit(txs)
    keys = jax.random.split(jax.random.key(7), 3)
    for key in keys:
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, noise=tuple(_t(z) for z in _jax_step_noise(key, backward)))
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-10)
    # Every step went through the lane sweep, with the ancestor dynamics under PGAS.
    assert len(calls) == len(keys)
    assert all((pt is not None) == ancestor_sampling for pt in calls)


def test_model_pieces_match_jax(data):
    """drift, the potentials and the transition density on random states."""
    _, ys = data
    _, jG0, jMt, jGt = jtl.get_feynman_kac(jnp.asarray(ys))
    tM0, tG0, tMt, tGt = ttl.get_feynman_kac(_t(ys))
    rng = np.random.default_rng(1)
    x, xn = rng.standard_normal((2, T - 1, N, 1)) + 1.0
    close = lambda got, want: np.testing.assert_allclose(  # noqa: E731
        got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)
    close(ttl.drift(_t(x), 0.15, 0.12, 0.10), jtl.drift(jnp.asarray(x), 0.15, 0.12, 0.10))
    close(tG0(_t(x[0])), jG0(jnp.asarray(x[0])))
    close(tM0.logpdf(_t(x[0])), jax.scipy.stats.norm.logpdf(x[0], 1.0, 0.5).sum(-1))
    close(tMt.logpdf(_t(xn), _t(x), tMt.params),
          jax.vmap(jMt.logpdf)(jnp.asarray(xn), jnp.asarray(x), jMt.params))
    close(tGt(_t(xn), _t(x), tGt.params),
          jax.vmap(jGt)(jnp.asarray(xn), jnp.asarray(x), jGt.params))
    # The port's pair factors are centred (another gauge): their scores agree.
    def scores(rf, cf, rb, cb):
        return (rb[..., :, None] + cb[..., None, :]
                + torch.einsum("...ik,...jk->...ij", *(torch.as_tensor(np.asarray(z))
                                                       for z in (rf, cf))))
    close(scores(*tMt.logpdf_factors(_t(x), _t(xn), tMt.params)),
          scores(*(torch.as_tensor(np.asarray(z)) for z in jax.vmap(jMt.logpdf_factors)(
              jnp.asarray(x), jnp.asarray(xn), jMt.params))))


def test_get_data_law():
    """The simulated path follows the model: one-step residuals are N(0,
    sig_x^2) and observation errors N(0, sig_y^2)."""
    n = 4000
    xs, ys = ttl.get_data(n, generator=torch.Generator().manual_seed(3), device="cpu")
    assert xs.shape == ys.shape == (n, 1) and xs.dtype == torch.float64
    resid = xs[1:, 0] - ttl.drift(xs[:-1, 0], 0.15, 0.12, 0.10)
    np.testing.assert_allclose(float(resid.std()), 0.3, rtol=0.05)
    np.testing.assert_allclose(float((ys - xs).std()), 0.1, rtol=0.05)
    assert abs(float(resid.mean())) < 4 * 0.3 / np.sqrt(n)
    xs32, _ = ttl.get_data(8, generator=torch.Generator().manual_seed(3), device="cpu",
                           dtype=torch.float32)
    assert xs32.dtype == torch.float32


def test_default_device_is_the_card():
    """Called without a device the model functions allocate on the card (so they
    raise where there is none); the tests ask for the CPU."""
    from aux_ssm_tpu_torch import default_device
    from aux_ssm_tpu_torch.models import rare_event, stochastic_volatility
    assert default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults allocate there")
    gen = torch.Generator().manual_seed(0)
    for build in (lambda: ttl.get_data(4, generator=gen),
                  lambda: stochastic_volatility.get_data(0.0, 0.9, 2.0, 0.25, 2, 4,
                                                         generator=gen),
                  lambda: stochastic_volatility.get_dynamics(0.0, 0.9, 2.0, 0.25, 2),
                  lambda: rare_event.init_x(5.0, 0.8, 0.5, 2),
                  lambda: rare_event.get_feynman_kac(5.0, 0.8, 0.5, 2)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
