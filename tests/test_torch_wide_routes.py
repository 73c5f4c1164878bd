"""Shapes past the d x d kernels' instances, routed to the plain versions by
shape; the block-lane sweep past its register width; and the drivers'
`--debug-nans`, float64 on the CPU:

- `_build.has_instance` (the d x d kernels' widths, max(dx, dy) <= 32), and
  the block-lane choice, which has no d cap (as in the JAX package);
- an SV kalman-1 step at D = 33 (T = 8) against the JAX package's, given the
  noise JAX draws: states to rtol 1e-9, the same accept decisions, and none
  of the six d x d wrappers called (at D = 32 each is); C = 2 chains of the
  dense batched layout at D = 33 call none either, each chain the one-chain
  step's values;
- a spatial csmc-guided step at d = 81 (`--D 9`, T = 4, N = 8) through the
  block-lane sweep (its plain version here; on the card the functor's wide
  path, past the 64 components its lanes keep in registers) against JAX's
  generic loop (its CPU path); and C = 2 chains at d = 81 as one batched
  step, bit for bit the chain loop, one block-lane call a step;
- `--debug-nans`: `BackendConfig(debug_nans=True).apply()` sets the backend,
  the runner raises FloatingPointError naming the iteration (and the chain
  of several) at the first non-finite state, not at all with the flag off,
  and a driver run with the flag goes to its end.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import spatial as jsp  # noqa: E402
from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu_torch import config as tconfig  # noqa: E402
from aux_ssm_tpu_torch.experiments import sv as tsv_driver  # noqa: E402
from aux_ssm_tpu_torch.experiments.runner import RunConfig, run_chain  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc as tcsmc  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import CSMCState  # noqa: E402
from aux_ssm_tpu_torch.models import spatial as tsp  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import _build, csmc_fwd as CF  # noqa: E402
from aux_ssm_tpu_torch.parallel import chains as tchains  # noqa: E402
from aux_ssm_tpu_torch.parallel.chains import broadcast_chains, run_sharded_chains  # noqa: E402

SV_ARGS = (0.0, 0.9, 2.0, 0.25)
SP_ARGS = (0.3, 4.0, -0.25, 1)  # sigma_x, nu, tau, r_y
f64 = jnp.float64
DXD = ("make_elements", "filter_scan", "ell", "backward_maps", "affine_scan",
       "logdensity_steps")


def _t(z):
    return torch.as_tensor(np.array(z))


def test_width_predicates():
    assert _build.MAX_DIM == 32
    assert _build.has_instance(16, 4) and _build.has_instance(32, 32)
    assert not _build.has_instance(33, 1) and not _build.has_instance(3, 40)
    x = {d: torch.zeros(2, d) for d in (1, 64, 65, 81)}
    Mt = type("Mt", (), {"block_propagate": 1})()
    Gt = type("Gt", (), {"block_logw": 1})()
    take = [tcsmc._use_block_lane_forward(x[d], Mt, Gt, tcsmc.resampling_mod.multinomial,
                                          None, 25) for d in (1, 64, 65, 81)]
    assert take == [False, True, True, True]


def _count_dxd(monkeypatch):
    """Count the calls of the six d x d wrappers where their callers look
    them up."""
    F = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")
    S = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")
    KF = importlib.import_module("aux_ssm_tpu_torch.ops.cuda.kalman_fused")
    calls = dict.fromkeys(DXD, 0)
    for mod, name in ((KF, "make_elements"), (F, "filter_scan"), (KF, "ell"),
                      (S, "backward_maps"), (S, "affine_scan"), (KF, "logdensity_steps")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw))
    return calls


def _kalman_noise(key, T, D):
    aux_key, sample_key, accept_key = jax.random.split(key, 3)
    return tuple(_t(z) for z in (jax.random.normal(aux_key, (T, D), f64),
                                 jax.random.normal(sample_key, (T, D), f64),
                                 jax.random.uniform(accept_key, (), f64)))


def test_sv_kalman_step_past_the_instances_matches_jax(monkeypatch):
    T, D, delta = 8, 33, 0.05
    xs, ys = (np.array(z) for z in jsv.get_data(jax.random.key(2), *SV_ARGS, D, T))
    jinit, jkernel = jsv.get_kalman_kernel(jnp.asarray(ys), *SV_ARGS, True, 1)
    tinit, tkernel = tsv.get_kalman_kernel(_t(ys), *SV_ARGS, True, order=1)
    calls = _count_dxd(monkeypatch)
    jstep = jax.jit(lambda k, s: jkernel(k, s, delta))
    jstate, tstate = jinit(jnp.asarray(xs)), tinit(_t(xs))
    accepted = []
    for key in jax.random.split(jax.random.key(5), 3):
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, delta, noise=_kalman_noise(key, T, D))
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
        accepted.append(bool(tstate.updated))
    assert any(accepted)
    assert calls == dict.fromkeys(DXD, 0)
    # At D = 32 the step goes through every wrapper (the CPU runs their
    # plain versions behind them).
    xs32, ys32 = xs[:, :32], ys[:, :32]
    init32, kernel32 = tsv.get_kalman_kernel(_t(ys32), *SV_ARGS, True, order=1)
    kernel32(init32(_t(xs32)), delta, noise=_kalman_noise(jax.random.key(6), T, 32))
    assert all(calls[name] > 0 for name in DXD)


def test_sv_kalman_chains_past_the_instances(monkeypatch):
    """The dense batched layout at D = 33: C = 2 chains, none of the d x d
    wrappers, each chain the one-chain step's values on its noise."""
    T, D, C = 6, 33, 2
    xs, ys = (np.array(z) for z in jsv.get_data(jax.random.key(3), *SV_ARGS, D, T))
    init1, kernel1 = tsv.get_kalman_kernel(_t(ys), *SV_ARGS, True, order=1)
    initC, kernelC = tsv.get_kalman_kernel(_t(ys), *SV_ARGS, True, order=1, chains=True)
    x0 = _t(xs[None] + 0.05 * np.random.default_rng(0).standard_normal((C, T, D)))
    delta = torch.tensor([0.03, 0.06], dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    noise = (torch.randn(C, T, D, generator=g, dtype=torch.float64),
             torch.randn(C, T, D, generator=g, dtype=torch.float64),
             torch.rand(C, generator=g, dtype=torch.float64))
    calls = _count_dxd(monkeypatch)
    out = kernelC(initC(x0), delta, noise=noise)
    assert calls == dict.fromkeys(DXD, 0)
    for c in range(C):
        one = kernel1(init1(x0[c]), delta[c], noise=tuple(z[c] for z in noise))
        assert bool(out.updated[c]) == bool(one.updated)
        np.testing.assert_allclose(out.x[c].numpy(), one.x.numpy(), rtol=1e-12, atol=1e-13)


def _spatial_guided_noise(key, T, N, d):
    aux_key, inner = jax.random.split(key)
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    return tuple(_t(z) for z in (
        jax.random.normal(aux_key, (T, d), f64), jax.random.normal(key_init, (N, d), f64),
        jax.random.uniform(key_res, (T - 1, N), f64),
        jax.random.normal(key_prop, (T - 1, N, d), f64),
        jax.random.uniform(key_anc, (T - 1,), f64), jax.random.uniform(key_bwd, (T,), f64)))


@pytest.fixture(scope="module")
def wide_spatial():
    T, side = 4, 9
    xs, ys = jsp.get_data(np.random.default_rng(4), SP_ARGS[0], SP_ARGS[3], SP_ARGS[2],
                          SP_ARGS[1], side, T)
    return np.array(xs), np.array(ys), T, side


def _count_block_lane(monkeypatch):
    """The width d of each block-lane call."""
    calls, fn = [], CF.block_lane_scan
    monkeypatch.setattr(CF, "block_lane_scan",
                        lambda Mt, Gt, eps, *a: calls.append(eps.shape[-2]) or fn(Mt, Gt, eps, *a))
    return calls


def test_spatial_guided_step_past_the_block_lane_width_matches_jax(wide_spatial, monkeypatch):
    xs, ys, T, side = wide_spatial
    N, d = 8, side * side
    jinit, jkernel = jsp.get_guided_csmc_kernel(jnp.asarray(ys), *SP_ARGS, side, N,
                                                backward=True)
    tinit, tkernel = tsp.get_guided_csmc_kernel(_t(ys), *SP_ARGS, side, N, backward=True)
    calls = _count_block_lane(monkeypatch)
    delta = np.random.default_rng(1).uniform(0.05, 0.3, T)
    jstep = jax.jit(lambda k, s: jkernel(k, s, jnp.asarray(delta)))
    jstate, tstate = jinit(jnp.asarray(xs)), tinit(_t(xs))
    moved = 0
    for key in jax.random.split(jax.random.key(9), 2):
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, _t(delta), noise=_spatial_guided_noise(key, T, N, d))
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
        moved += int(np.asarray(jstate.updated).sum())
    assert moved > 0 and calls == [d, d]


def test_spatial_guided_chains_past_the_block_lane_width(wide_spatial, monkeypatch):
    xs, ys, T, side = wide_spatial
    N, C = 8, 2
    init1, kernel1 = tsp.get_guided_csmc_kernel(_t(ys), *SP_ARGS, side, N, backward=True)
    _, kernelC = tsp.get_guided_csmc_kernel(_t(ys), *SP_ARGS, side, N, backward=True,
                                            chains=True)
    assert kernelC.chain_axis
    calls = _count_block_lane(monkeypatch)
    x0 = _t(xs[None] + 0.2 * np.random.default_rng(2).standard_normal((C,) + xs.shape))
    delta = _t(np.random.default_rng(3).uniform(0.05, 0.3, (C, T)))
    s_loop = s_batch = tchains._stack_states([init1(x0[c]) for c in range(C)])
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        noise = ((torch.randn(x0.shape, generator=gen, dtype=x0.dtype),)
                 + tcsmc.draw_noise(x0, N, tcsmc.resampling_mod.multinomial, gen))
        s_loop = tchains.chain_loop(kernel1)(s_loop, delta, noise=noise)
        s_batch = kernelC(s_batch, delta, noise=noise)
        assert torch.equal(s_batch.x, s_loop.x) and torch.equal(s_batch.updated, s_loop.updated)
    assert calls == [side * side] * (2 * (C + 1))  # a call a step, batched or one chain's


# --------------------------------------------------------------------------
# --debug-nans
# --------------------------------------------------------------------------

def _walk(bad_at=None, chain=None):
    """A kernel that moves every chain by delta and, at iteration `bad_at`
    (counted by its calls), puts a NaN into `chain` (or the one chain)."""
    calls = [0]

    def kernel(state, delta, generator=None):
        x = state.x + torch.as_tensor(delta, dtype=state.x.dtype)[..., None]
        if calls[0] == bad_at:
            x = x.clone()
            x[(chain, 0) if chain is not None else (0,)] = float("nan")
        calls[0] += 1
        return CSMCState(x=x, updated=torch.ones_like(state.updated))
    return kernel


def test_backend_config_takes_debug_nans():
    before = torch.get_default_dtype()
    try:
        cfg = tconfig.BackendConfig(precision="double", platform="cpu", debug_nans=True)
        assert cfg.apply() is cfg and torch.get_default_dtype() == torch.float64
    finally:
        torch.set_default_dtype(before)
    with pytest.raises(ValueError, match="device_count"):  # no card here, and no CPU fallback
        tconfig.MeshConfig().build()


def test_debug_nans_raises_naming_the_iteration_and_the_chain():
    init = CSMCState(x=torch.zeros(4, dtype=torch.float64), updated=torch.zeros(4, dtype=bool))
    cfg = RunConfig(n_samples=6, burnin=5, delta_init=0.1)
    with pytest.raises(FloatingPointError, match="burn-in iteration 3$"):
        run_chain(_walk(bad_at=3), init, cfg, debug_nans=True)
    with pytest.raises(FloatingPointError, match="sampling iteration 2$"):
        run_chain(_walk(bad_at=7), init, cfg, debug_nans=True)
    with pytest.raises(FloatingPointError, match="burn-in iteration 1, chain 2 of 3$"):
        run_sharded_chains(_walk(bad_at=1, chain=2), broadcast_chains(init, 3), cfg,
                           debug_nans=True)
    # Off (the default): the NaN passes unseen, and the run goes to its end.
    res = run_chain(_walk(bad_at=3), init, cfg)
    assert bool(torch.isnan(res.state.x).any())
    clean = run_chain(_walk(), init, cfg, debug_nans=True)
    assert bool(torch.isfinite(clean.state.x).all())


def test_debug_nans_names_no_chain_for_a_tensor_without_the_chain_axis():
    """A NaN in a tensor that does not lead with the chain axis (here a
    scalar of the state) is reported without a chain; a NaN in a chain's
    row names that chain, whatever the other tensors hold."""
    from aux_ssm_tpu_torch.experiments.runner import check_finite
    C = 3
    x = torch.zeros(C, 4, dtype=torch.float64)
    shared = CSMCState(x=x, updated=torch.tensor(float("nan"), dtype=torch.float64))
    with pytest.raises(FloatingPointError, match="burn-in iteration 4$"):
        check_finite(shared, torch.ones(C), 0, 4, n_chains=C)
    x[1, 2] = float("inf")
    with pytest.raises(FloatingPointError, match="sampling iteration 0, chain 1 of 3$"):
        check_finite(CSMCState(x=x, updated=torch.zeros(C, dtype=bool)), torch.ones(C), 1, 0,
                     n_chains=C)
    check_finite(CSMCState(x=torch.zeros(C, 4), updated=torch.zeros(C, dtype=bool)),
                 torch.ones(C), 1, 0, n_chains=C)


def test_driver_with_debug_nans_runs_to_its_end(tmp_path):
    before = torch.get_default_dtype()
    try:
        res = tsv_driver.main(["--style", "csmc", "--platform", "cpu", "--T", "8", "--D", "2",
                               "--N", "8", "--burnin", "3", "--n-samples", "4", "--no-verbose",
                               "--debug-nans", "--n-chains", "2",
                               "--out", str(tmp_path / "out.npz")])
    finally:
        torch.set_default_dtype(before)
    assert res.stats.step.shape == (2,) and bool(torch.isfinite(res.state.x).all())
