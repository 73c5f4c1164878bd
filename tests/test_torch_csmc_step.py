"""Whole auxiliary-cSMC steps of the port's stochastic-volatility model
against the JAX package's, given the noise JAX draws (the model's pieces:
`tests/test_torch_sv_model.py`).

- Whole steps of both styles (T=16, D=4, N=8; `backward` and `gradient`
  both ways): JAX runs with AUX_SSM_FUSED_CSMC="0" (its generic forward and
  backward loops) or "xla" (its fused algebra on the CPU); the port always
  takes its fused path (factor or block-lane sweep, factor backward sweep).
  Given the same noise the picked indices are identical and the states
  agree to rtol 1e-9 in float64. JAX's block-lane oracle (guided, "xla")
  computes in float32 whatever its inputs, so there the states agree to
  f32 rounding (2e-5) instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
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


def _jax_step_noise(key, backward):
    """Every random number of one JAX aux-cSMC step, as csmc_aux.py and
    csmc.py draw them from `key`."""
    aux_key, inner = jax.random.split(key)
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    if backward:
        us = jax.random.uniform(key_bwd, (T,), f64)
    else:  # ancestor scanning: jax.random.choice's one uniform
        us = jnp.zeros(T, f64).at[-1].set(jax.random.uniform(key_bwd, (), f64))
    return (jax.random.normal(aux_key, (T, D), f64), jax.random.normal(key_init, (N, D), f64),
            jax.random.uniform(key_res, (T - 1, N), f64),
            jax.random.normal(key_prop, (T - 1, N, D), f64),
            jax.random.uniform(key_anc, (T - 1,), f64), us)


@pytest.mark.parametrize("mode", ["0", "xla"])
@pytest.mark.parametrize("style", ["csmc", "csmc-guided"])
@pytest.mark.parametrize("backward,gradient", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_step_matches_jax_given_noise(data, monkeypatch, mode, style, backward, gradient):
    xs_true, ys = data
    monkeypatch.setenv("AUX_SSM_FUSED_CSMC", mode)
    if style == "csmc":
        jinit, jkernel = jsv.get_csmc_kernel(jnp.asarray(ys), NU, PHI, TAU, RHO, N,
                                             backward=backward, gradient=gradient)
        tinit, tkernel = tsv.get_csmc_kernel(_t(ys), NU, PHI, TAU, RHO, N, backward=backward,
                                             gradient=gradient)
    else:
        jinit, jkernel = jsv.get_guided_csmc_kernel(jnp.asarray(ys), NU, PHI, TAU, RHO, N,
                                                    backward=backward, gradient=gradient)
        tinit, tkernel = tsv.get_guided_csmc_kernel(_t(ys), NU, PHI, TAU, RHO, N,
                                                    backward=backward, gradient=gradient,
                                                    eig=_eig())
    delta = np.random.default_rng(6).uniform(0.2, 1.0, T)
    jstep = jax.jit(lambda k, s: jkernel(k, s, jnp.asarray(delta)))
    jstate, tstate = jinit(jnp.asarray(xs_true)), tinit(_t(xs_true))
    f32_oracle = style == "csmc-guided" and mode == "xla"
    for key in jax.random.split(jax.random.key(7), 2):
        jstate = jstep(key, jstate)
        noise = tuple(_t(z) for z in _jax_step_noise(key, backward))
        tstate = tkernel(tstate, _t(delta), noise=noise)
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        _close(tstate.x, jstate.x, *((2e-5, 2e-5) if f32_oracle else (1e-9, 1e-10)))
        if f32_oracle:  # carry on from the same state
            tstate = type(tstate)(x=_t(jstate.x), updated=tstate.updated)


def test_parallel_is_not_the_sequential_sweep(data, monkeypatch):
    """`parallel=True` is the PIT cSMC: a step at T=16 (four tree levels)
    calls row_lse at each and runs neither sequential sweep (whole PIT steps
    against JAX: tests/test_torch_pit.py)."""
    xs_true, ys = data
    from aux_ssm_tpu_torch.kernels import pit
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd
    calls = []
    row_lse = pit.kernels.row_lse
    monkeypatch.setattr(pit.kernels, "row_lse", lambda *a: calls.append(1) or row_lse(*a))
    for name in ("forward_factor_scan", "backward_factor_scan"):
        monkeypatch.setattr(csmc_fwd, name, lambda *a, **k: pytest.fail("a sequential sweep ran"))
    init, kernel = tsv.get_csmc_kernel(_t(ys), NU, PHI, TAU, RHO, N, parallel=True)
    state = kernel(init(_t(xs_true)), torch.full((T,), 0.3, dtype=torch.float64),
                   generator=torch.Generator().manual_seed(0))
    assert calls == [1] * 4 and state.x.shape == (T, D)
    assert bool(torch.isfinite(state.x).all())
