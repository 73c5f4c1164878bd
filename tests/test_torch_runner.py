"""The port's online statistics and experiment loop against the JAX
package's: `update_stats` on random inputs, and `run_chain` (burn-in with
delta adaptation, then frozen-delta sampling) driven by a deterministic toy
kernel whose per-step `updated` pattern depends only on the state.

Tolerance: float64 on both sides, the same recurrences, and the adaptation
rate in float32 on both (JAX casts the iteration index to float32): the
final delta, every statistic and the collected samples agree to rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.experiments import runner as jrunner  # noqa: E402
from aux_ssm_tpu.kernels.csmc_base import CSMCState as JState  # noqa: E402
from aux_ssm_tpu.utils import stats as jstats  # noqa: E402
from aux_ssm_tpu_torch import CSMCState as TState  # noqa: E402
from aux_ssm_tpu_torch.experiments import RunConfig, run_chain  # noqa: E402
from aux_ssm_tpu_torch.utils import stats as tstats  # noqa: E402

T, D = 12, 3
FIELDS = ("ejsd", "mean_x", "mean_x2", "accept_cum", "accept_win", "step")


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("accept_shape", [(), (T,)])
def test_update_stats_matches_jax(accept_shape):
    rng = np.random.default_rng(len(accept_shape))
    js = jstats.init_stats(jnp.zeros((T, D)), accept_shape=accept_shape)
    ts = tstats.init_stats(torch.zeros(T, D, dtype=torch.float64), accept_shape=accept_shape)
    x = rng.standard_normal((T, D))
    for _ in range(7):
        x_new = x + rng.standard_normal((T, D))
        acc = rng.uniform(size=accept_shape) < 0.5
        js = jstats.update_stats(js, x, x_new, jnp.asarray(acc), beta=0.1)
        ts = tstats.update_stats(ts, torch.as_tensor(x), torch.as_tensor(x_new),
                                 torch.as_tensor(acc), beta=0.1)
        x = x_new
    for f in FIELDS:
        _close(getattr(ts, f), getattr(js, f))
    _close(tstats.variance(ts), jstats.variance(js))


def _toy_jax(key, state, delta):
    """Affine drift plus delta, a step counter in the last column, and a
    per-step update pattern (counter + t) % 3 != 0."""
    x = state.x
    c = x[:, -1] + 1.0
    d = jnp.broadcast_to(delta, (T,))[:, None]
    body = 0.9 * x[:, :-1] + 0.1 * jnp.roll(x[:, :-1], 1, axis=0) + 0.1 * d
    upd = (c.astype(jnp.int32) + jnp.arange(T)) % 3 != 0
    return JState(x=jnp.concatenate([body, c[:, None]], axis=1), updated=upd)


def _toy_torch(state, delta, generator=None):
    x = state.x
    c = x[:, -1] + 1.0
    d = delta.expand(T)[:, None]
    body = 0.9 * x[:, :-1] + 0.1 * torch.roll(x[:, :-1], 1, dims=0) + 0.1 * d
    upd = (c.to(torch.int32) + torch.arange(T)) % 3 != 0
    return TState(x=torch.cat([body, c[:, None]], dim=1), updated=upd)


@pytest.mark.parametrize("vector_delta,on_window", [(True, True), (False, False)])
def test_run_chain_matches_jax(vector_delta, on_window):
    cfg = dict(n_samples=20, burnin=30, target_alpha=0.5, delta_init=0.3, learning_rate=0.3,
               beta=0.1, adapt_on_window=on_window)
    x0 = np.concatenate([np.random.default_rng(0).standard_normal((T, D - 1)),
                         np.zeros((T, 1))], axis=1)
    delta0 = np.linspace(0.1, 1.0, T) if vector_delta else None
    jres = jrunner.run_chain(
        jax.random.key(0), _toy_jax, JState(x=jnp.asarray(x0), updated=jnp.zeros(T, bool)),
        jrunner.RunConfig(**cfg), collect_samples=True,
        delta_init=None if delta0 is None else jnp.asarray(delta0))
    tres = run_chain(_toy_torch, TState(x=torch.as_tensor(x0),
                                        updated=torch.zeros(T, dtype=torch.bool)),
                     RunConfig(**cfg), collect_samples=True,
                     delta_init=None if delta0 is None else torch.as_tensor(delta0))
    assert tres.delta.shape == ((T,) if vector_delta else ())
    _close(tres.delta, jres.delta)
    for f in FIELDS:
        _close(getattr(tres.stats, f), getattr(jres.stats, f))
    _close(tres.samples, jres.samples)
    _close(tres.state.x, jres.state.x)
    assert tres.sampling_time > 0

