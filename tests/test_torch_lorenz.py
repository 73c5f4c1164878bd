"""The port's Lorenz-63 model (`aux_ssm_tpu_torch.models.lorenz`) against the
JAX package's `models/lorenz.py`: the observation grid on the Mider data, the
conjugate theta posterior, the initial trajectory, the target's whiteners,
the simulation given JAX's normals, and the Kalman and Gibbs steps given the
noise JAX draws (T=64, observed every 4 steps, f64).

Tolerance: float64 on both sides. The closed forms (theta posterior,
interpolation, whiteners, the simulation) are the same arithmetic in other
orders: rtol 1e-12. The steps run the port's chunked scans against JAX's
associative scan, ~1e-14 apart; rtol 1e-9 catches any wrong term, and every
accept decision must be identical. At delta = 10 the steps accept and reject
(at 1e-2 the linearised proposal of this short grid accepts every time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import lorenz as jl  # noqa: E402
from aux_ssm_tpu_torch.experiments.lorenz import MIDER_DATA  # noqa: E402
from aux_ssm_tpu_torch.models import lorenz as tl  # noqa: E402

THETA_TRUE = np.array([10.0, 28.0, 8.0 / 3.0])
SIGMA_X, SIG_Y, DT = 3.0, 0.5, 0.02
N_STEPS, EVERY = 64, 4
SIGMA_THETA = 100.0
DELTA = 10.0
M0, P0 = np.array([1.5, -1.5, 25.0]), np.eye(3)


def t64(z):
    return torch.as_tensor(np.array(z), dtype=torch.float64)


@pytest.fixture(scope="module")
def synthetic():
    xs = np.asarray(jl.sample_trajectory(jax.random.key(0), jnp.asarray(M0), jnp.asarray(P0),
                                         jnp.asarray(THETA_TRUE), SIGMA_X, DT, N_STEPS))
    obs_idx = np.arange(0, N_STEPS, EVERY)
    ys_obs = xs[obs_idx, 1:] + SIG_Y * np.random.default_rng(0).standard_normal(
        (len(obs_idx), 2))
    data = np.column_stack([obs_idx * DT, ys_obs])
    return xs, data, jl.observations_model(data, SIG_Y, N_STEPS, EVERY)


@pytest.fixture(scope="module")
def mider():
    return np.loadtxt(MIDER_DATA, delimiter=",", skiprows=1)


def test_sample_trajectory_given_jax_normals():
    key = jax.random.key(3)
    want = jl.sample_trajectory(key, jnp.asarray(M0), 2.0 * jnp.asarray(P0),
                                jnp.asarray(THETA_TRUE), SIGMA_X, DT, N_STEPS)
    # jax.random.multivariate_normal (Cholesky) and the scan's per-step keys.
    init_key, scan_key = jax.random.split(key)
    eps0 = jax.random.normal(init_key, (3,))
    eps = jnp.stack([jax.random.normal(k, (3,)) for k in jax.random.split(scan_key, N_STEPS - 1)])
    got = tl.sample_trajectory(M0, 2.0 * P0, THETA_TRUE, SIGMA_X, DT, N_STEPS,
                               noise=(np.array(eps0), np.array(eps)), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("freq", [1, 2, 4, 8])
def test_observations_model_on_mider(mider, freq):
    dt = freq * 1e-4
    n_steps = int(round(mider[-1, 0] / dt)) + 1
    obs_idx = np.rint(mider[:, 0] / dt).astype(np.int64)  # freq 8: 12.5 steps, rounded
    got = tl.observations_model(mider, 5.0 ** 0.5, n_steps, obs_idx=obs_idx)
    want = jl.observations_model(mider, 5.0 ** 0.5, n_steps, obs_idx=obs_idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)  # NaN where NaN
    assert np.isfinite(got[0][obs_idx]).all() and np.isnan(got[0]).sum() == 2 * (n_steps - 201)
    with pytest.raises(ValueError, match="do not fit"):
        tl.observations_model(mider, 1.0, n_steps - 1 if freq < 8 else obs_idx[-1],
                              obs_idx=obs_idx)


def test_theta_posterior_matches_jax(synthetic):
    xs = synthetic[0]
    want = jl.theta_posterior_mean_and_chol(jnp.asarray(xs), SIGMA_THETA, DT, SIGMA_X)
    got = tl.theta_posterior_mean_and_chol(t64(xs), SIGMA_THETA, DT, SIGMA_X)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_init_x_and_whiteners_match_jax(mider):
    n_steps = 5001  # freq 4
    got = tl.init_x_fn(mider, n_steps, dtype=torch.float64, device="cpu")
    want = jl.init_x_fn(jnp.asarray(mider), n_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)

    P0m = np.diag([400.0, 20.0, 20.0])
    Rs = jl.observations_model(mider, 5.0 ** 0.5, n_steps,
                               obs_idx=np.rint(mider[:, 0] / 4e-4).astype(np.int64))[2]
    got = tl.target_whiteners(t64(M0), t64(P0m), t64(Rs), SIGMA_X, 4e-4)
    want = jl.target_whiteners(jnp.asarray(M0), jnp.asarray(P0m), jnp.asarray(Rs), SIGMA_X, 4e-4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, err_msg=k)


def _kalman_noise(key):
    """The noise of one JAX Kalman step, drawn as kernels/kalman.py draws it."""
    aux_key, sample_key, accept_key = jax.random.split(key, 3)
    return (jax.random.normal(aux_key, (N_STEPS, 3)), jax.random.normal(sample_key, (N_STEPS, 3)),
            jax.random.uniform(accept_key, ()))


@pytest.mark.parametrize("parallel", [True, False])
def test_kalman_step_matches_jax_given_noise(synthetic, parallel):
    xs, _, obs = synthetic
    jinit, jkernel = jl.get_kalman_kernel(*map(jnp.asarray, obs), jnp.asarray(M0),
                                          jnp.asarray(P0), jnp.asarray(THETA_TRUE), SIGMA_X, DT,
                                          parallel)
    tinit, tkernel = tl.get_kalman_kernel(*map(t64, obs), t64(M0), t64(P0), THETA_TRUE,
                                          SIGMA_X, DT, parallel)
    jstate, tstate = jinit(jnp.asarray(xs)), tinit(t64(xs))
    np.testing.assert_allclose(float(tstate.log_target), float(jstate.log_target), rtol=1e-12)
    jstep = jax.jit(lambda k, s: jkernel(k, s, DELTA))
    accepted = []
    for key in jax.random.split(jax.random.key(3 + parallel), 5):
        noise = tuple(t64(z) for z in _kalman_noise(key))
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, DELTA, noise=noise)
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(tstate.log_target), float(jstate.log_target), rtol=1e-9)
        accepted.append(bool(tstate.updated))
    assert any(accepted) and not all(accepted), accepted


@pytest.mark.parametrize("parallel", [True, False])
def test_gibbs_step_matches_jax_given_noise(synthetic, parallel):
    xs, _, obs = synthetic
    jinit, jkernel = jl.get_gibbs_kernel(*map(jnp.asarray, obs), jnp.asarray(M0),
                                         jnp.asarray(P0), SIGMA_X, DT, SIGMA_THETA, parallel)
    tinit, tkernel = tl.get_gibbs_kernel(*map(t64, obs), t64(M0), t64(P0), SIGMA_X, DT,
                                         SIGMA_THETA, parallel)
    jstate, tstate = jinit(jnp.asarray(xs), jnp.zeros(3)), tinit(t64(xs), np.zeros(3))
    jstep = jax.jit(lambda k, s: jkernel(k, s, DELTA))
    accepted = []
    for key in jax.random.split(jax.random.key(7 + parallel), 6):
        key_traj, key_theta = jax.random.split(key)
        noise = (tuple(t64(z) for z in _kalman_noise(key_traj)),
                 t64(jax.random.normal(key_theta, (3,))))
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, DELTA, noise=noise)
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tstate.theta.numpy(), np.asarray(jstate.theta), rtol=1e-9)
        assert tstate.kalman_state.log_target is None
        accepted.append(bool(tstate.updated))
    assert any(accepted) and not all(accepted), accepted


def test_gibbs_state_never_caches_the_target(synthetic, monkeypatch):
    """theta changes every step, so a cached log target would be that of the
    previous theta: the Gibbs state's `log_target` stays None. The theta-free
    whiteners are factorised once, when the kernel is built, never a step."""
    xs, _, obs = synthetic
    calls = []
    real = tl.target_whiteners
    monkeypatch.setattr(tl, "target_whiteners", lambda *a: calls.append(1) or real(*a))
    init, kernel = tl.get_gibbs_kernel(*map(t64, obs), t64(M0), t64(P0), SIGMA_X, DT,
                                       SIGMA_THETA, True)
    state = init(t64(xs), THETA_TRUE)
    assert state.kalman_state.log_target is None
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        state = kernel(state, 1e-2, generator=gen)
        assert state.kalman_state.log_target is None
    assert len(calls) == 1
    assert bool(torch.isfinite(state.x).all()) and bool(torch.isfinite(state.theta).all())
