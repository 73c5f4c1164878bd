"""The d x d kernels' widest instance and the shapes past it, routed by
shape and dtype; the block-lane sweep past its register width; and the
drivers' `--debug-nans`, on the CPU:

- `_build.has_instance` (the d x d kernels' widths: max(dx, dy) <= 48 in
  float32, <= 32 in float64), and the block-lane choice, which has no d cap
  (as in the JAX package);
- an SV kalman-1 step past the instances against the JAX package's, given
  the noise JAX draws: at D = 33 (T = 8) in float64, states to rtol 1e-9 and
  the same accept decisions; at D = 49 in float32 (JAX in float32 too), as
  the D = 40 steps below are held; none of the six d x d wrappers called (at
  D = 32 in float64 and D = 48 in float32 each is); C = 2 chains of the
  dense batched layout at D = 33 call none either, each chain the one-chain
  step's values;
- SV kalman-1 and kalman-2 steps at D = 40 (T = 16) in float32, inside the
  float32 D = 48 instance (and JAX's Pallas range, d <= 43 at T <= 128),
  against the JAX package's float32 steps given the noise they draw: the
  same accept decisions, each of the six wrappers called (10 calls a step),
  log alpha within LOG_ALPHA_F32 and the states within X_F32 of JAX's. Each
  package's float32 step lies apart from the float64 step on the same data
  and noise: log alpha by 0.17-0.51 (JAX's jitted and eager kalman-1 steps)
  and 0.29-0.42 (the port's), the state by ~5e-4 (|x| ~ 1); mostly the drawn
  path itself moves, and the target and the auxiliary term at it with it. So
  the two float32 steps may lie ~1 apart in log alpha and ~1e-3 in the
  state; a wrong term moves log alpha by units. C = 2 chains of the dense
  batched layout at D = 40 in float32: one call of each wrapper a step as
  for one chain, each chain's accept equal to its one-chain step's and its
  state and target within rtol 1e-6 (the CPU's batched plain ops round a
  chain's products otherwise than a one-chain call does, a few float32 ulp,
  at D = 30 as at 40; on the card `chip_smoke.py` phase 36 holds each
  chain of the kernels' launches to a one-chain launch bit for bit);
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
    f32, f64 = torch.float32, torch.float64
    assert _build.MAX_DIMS == {f32: 48, f64: 32}
    assert _build.has_instance(16, 4, dtype=f64) and _build.has_instance(32, 32, dtype=f64)
    assert not _build.has_instance(33, 1, dtype=f64) and not _build.has_instance(3, 40, dtype=f64)
    assert _build.has_instance(32, 32, dtype=f32) and _build.has_instance(3, 48, dtype=f32)
    assert not _build.has_instance(49, 1, dtype=f32) and not _build.has_instance(3, 49, dtype=f32)
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


@pytest.mark.parametrize("dtype,D", [("float64", 33), ("float32", 49)])
def test_sv_kalman_step_past_the_instances_matches_jax(monkeypatch, dtype, D):
    T, delta = 8, 0.05
    calls = _count_dxd(monkeypatch)
    if dtype == "float32":
        accepted = _f32_steps_against_jax(monkeypatch, T, D, 1, delta, 5, calls, 0)
    else:
        xs, ys = (np.array(z) for z in jsv.get_data(jax.random.key(2), *SV_ARGS, D, T))
        jinit, jkernel = jsv.get_kalman_kernel(jnp.asarray(ys), *SV_ARGS, True, 1)
        tinit, tkernel = tsv.get_kalman_kernel(_t(ys), *SV_ARGS, True, order=1)
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
    # At the dtype's last instance (D = 32 in float64, 48 in float32) the step
    # goes through every wrapper (the CPU runs their plain versions behind
    # them).
    last = _build.MAX_DIMS[getattr(torch, dtype)]
    xs, ys = (z[:, :last].to(getattr(torch, dtype)) for z in tsv.get_data(
        *SV_ARGS, D, T, generator=torch.Generator().manual_seed(2), device="cpu"))
    init, kernel = tsv.get_kalman_kernel(ys, *SV_ARGS, True, order=1)
    kernel(init(xs), delta, noise=tuple(z.to(xs.dtype) for z in _kalman_noise(
        jax.random.key(6), T, last)))
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


# --------------------------------------------------------------------------
# float32 steps at D = 40 (the D = 48 instance) and D = 49 against JAX's
# --------------------------------------------------------------------------

DXD_STEP = {"make_elements": 2, "filter_scan": 2, "ell": 2, "backward_maps": 1,
            "affine_scan": 1, "logdensity_steps": 2}  # a step's wrapper calls
LOG_ALPHA_F32, X_F32 = 1.0, 2e-3  # the float32 steps' bounds (the module docstring)


def _log_alpha(args):
    """The MH log ratio of `_acceptance_probability`'s first eight arguments
    (either package's), in float64, before its clamp and exponential."""
    lt_p, lt_r, lp_f, lp_r, sd, u, x, xp = (np.asarray(z, dtype=np.float64) for z in args[:8])
    return float(lt_p - lt_r + lp_r - lp_f - (((xp - u) / sd) ** 2 - ((x - u) / sd) ** 2).sum())


def _f32_steps_against_jax(monkeypatch, T, D, order, delta, seed, calls, per_step):
    """Three float32 SV kalman steps (`order`), each from the simulated
    states, of JAX (x64 off: its float32 path, jitted) and of the port given
    the noise JAX draws: the same accept decisions, log alpha within
    LOG_ALPHA_F32 and the state within X_F32 (absolute) of JAX's, and each
    step calling each d x d wrapper `per_step` times its DXD_STEP count
    (`calls`, `_count_dxd`). Returns the accepts."""
    from aux_ssm_tpu.kernels import kalman as jkalman
    from aux_ssm_tpu_torch.kernels import kalman as tkalman
    ratios = {"jax": [], "port": []}
    jax_ratio = jkalman._acceptance_probability
    monkeypatch.setattr(jkalman, "_acceptance_probability", lambda *a: jax.debug.callback(
        lambda *v: ratios["jax"].append(_log_alpha(v)), *a[:8]) or jax_ratio(*a))
    port_ratio = tkalman._acceptance_probability
    monkeypatch.setattr(tkalman, "_acceptance_probability", lambda *a: ratios["port"].append(
        _log_alpha([z.numpy() if torch.is_tensor(z) else z for z in a])) or port_ratio(*a))
    with jax.enable_x64(False):
        xs, ys = (np.array(z) for z in jsv.get_data(jax.random.key(2), *SV_ARGS, D, T))
        jinit, jkernel = jsv.get_kalman_kernel(jnp.asarray(ys), *SV_ARGS, True, order)
        jstep = jax.jit(lambda k, s: jkernel(k, s, delta))
        jstate0 = jinit(jnp.asarray(xs))
        steps = []
        for key in jax.random.split(jax.random.key(seed), 3):
            jstate = jstep(key, jstate0)
            aux_key, sample_key, accept_key = jax.random.split(key, 3)
            noise = (jax.random.normal(aux_key, (T, D)), jax.random.normal(sample_key, (T, D)),
                     jax.random.uniform(accept_key, ()))
            steps.append((np.asarray(jstate.x), bool(jstate.updated),
                          tuple(_t(z) for z in noise)))
        jax.effects_barrier()
    tinit, tkernel = tsv.get_kalman_kernel(_t(ys), *SV_ARGS, True, order)
    state0 = tinit(_t(xs))
    for k, (xj, upd, noise) in enumerate(steps):
        before = dict(calls)
        state = tkernel(state0, delta, noise=noise)
        assert state.x.dtype == torch.float32
        assert {n: calls[n] - before[n] for n in DXD} == {
            n: per_step * v for n, v in DXD_STEP.items()}, k
        assert bool(state.updated) == upd, k
        assert abs(ratios["port"][k] - ratios["jax"][k]) <= LOG_ALPHA_F32, (
            k, ratios["port"][k], ratios["jax"][k])
        np.testing.assert_allclose(state.x.numpy(), xj, rtol=0, atol=X_F32)
    return [upd for _, upd, _ in steps]


@pytest.mark.parametrize("order,delta", [(1, 0.05), (2, 0.1)])
def test_sv_kalman_f32_step_in_the_d48_instance_matches_jax(monkeypatch, order, delta):
    calls = _count_dxd(monkeypatch)
    accepted = _f32_steps_against_jax(monkeypatch, 16, 40, order, delta, 5 + order, calls, 1)
    assert any(accepted)


def test_sv_kalman_f32_chains_in_the_d48_instance(monkeypatch):
    """The dense batched layout at D = 40 in float32: C = 2 chains in one
    step, each chain the one-chain step on its noise (within a few ulp: the
    module docstring), and one call of each d x d wrapper a step, as for one
    chain."""
    T, D, C = 16, 40, 2
    f32 = torch.float32
    xs, ys = (z.to(f32) for z in tsv.get_data(
        *SV_ARGS, D, T, generator=torch.Generator().manual_seed(3), device="cpu"))
    init1, kernel1 = tsv.get_kalman_kernel(ys, *SV_ARGS, True, order=1)
    initC, kernelC = tsv.get_kalman_kernel(ys, *SV_ARGS, True, order=1, chains=True)
    x0 = xs[None] + 0.05 * torch.randn(C, T, D, generator=torch.Generator().manual_seed(0),
                                       dtype=f32)
    delta = torch.tensor([0.04, 0.06], dtype=f32)
    g = torch.Generator().manual_seed(1)
    noise = (torch.randn(C, T, D, generator=g, dtype=f32),
             torch.randn(C, T, D, generator=g, dtype=f32), torch.rand(C, generator=g, dtype=f32))
    calls = _count_dxd(monkeypatch)
    out = kernelC(initC(x0), delta, noise=noise)
    assert calls == DXD_STEP and bool(out.updated.any())
    for c in range(C):
        one = kernel1(init1(x0[c]), delta[c], noise=tuple(z[c] for z in noise))
        assert bool(out.updated[c]) == bool(one.updated)
        np.testing.assert_allclose(out.x[c].numpy(), one.x.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(out.log_target[c]), float(one.log_target), rtol=1e-6)


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
