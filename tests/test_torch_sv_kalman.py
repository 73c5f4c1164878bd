"""The port's stochastic-volatility auxiliary-Kalman samplers (kalman-1 and
kalman-2) against the JAX package's `get_kalman_kernel`, step by step given
the noise JAX draws, at T=12 and the published D=30 (the kernels' D = 32
instance on the card); and the first-order factory's closed-form gradient
against `jax.grad` of JAX's `log_potential`.

Tolerance: float64 on both sides, the same algebra in other summation and
association orders (the port's chunked scans, JAX's associative scan); the
states agree to ~1e-12, and rtol 1e-9 catches any wrong term. The gradient
is one closed form against autodiff of the log density: rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402

NU, PHI, TAU, RHO = 0.0, 0.9, 2.0, 0.25  # experiments/sv.py
T, D = 12, 30
DELTA = 0.05
f64 = jnp.float64


@pytest.fixture(scope="module")
def data():
    xs, ys = jsv.get_data(jax.random.key(0), NU, PHI, TAU, RHO, D, T)
    return np.array(xs), np.array(ys)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("parallel", [True, False])
def test_step_matches_jax_given_noise(data, order, parallel):
    xs, ys = data
    jinit, jkernel = jsv.get_kalman_kernel(jnp.asarray(ys), NU, PHI, TAU, RHO, parallel, order)
    tinit, tkernel = tsv.get_kalman_kernel(torch.as_tensor(ys), NU, PHI, TAU, RHO, parallel,
                                           order)
    jstate, tstate = jinit(jnp.asarray(xs)), tinit(torch.as_tensor(xs))
    np.testing.assert_allclose(float(tstate.log_target), float(jstate.log_target), rtol=1e-12)
    jstep = jax.jit(lambda k, s: jkernel(k, s, DELTA))
    accepted = []
    for key in jax.random.split(jax.random.key(10 * order + parallel), 4):
        # The noise of one JAX step, drawn as kernels/kalman.py draws it.
        aux_key, sample_key, accept_key = jax.random.split(key, 3)
        noise = (jax.random.normal(aux_key, (T, D), f64),
                 jax.random.normal(sample_key, (T, D), f64),
                 jax.random.uniform(accept_key, (), f64))
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, DELTA, noise=tuple(torch.as_tensor(np.array(z)) for z in noise))
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(float(tstate.log_target), float(jstate.log_target),
                                   rtol=1e-9)
        accepted.append(bool(tstate.updated))
    assert any(accepted), "no step accepted: the comparison saw only the rejection branch"


def test_first_order_gradient_matches_jax_grad(data):
    _, ys = data
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, D)) * 2.0
    ys = ys.copy()
    ys[2, :5] = np.nan  # a missing observation's gradient is 0 on both sides
    want = jnp.nan_to_num(jax.grad(jsv.log_potential)(jnp.asarray(x), jnp.asarray(ys)))
    got = tsv.grad_log_potential(torch.as_tensor(x), torch.as_tensor(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
    assert not bool(got[2, :5].any())
