"""C chains of the cSMC styles and of the spatial sampler as one batched step
(x with a leading chain axis of C = 3), float64 on the CPU:

- against the JAX package: for each style, the port's batched step given
  each chain's noise as JAX draws it from the chain's key (`chain_keys`,
  what JAX's `run_sharded_chains` hands its vmapped kernel) equals the JAX
  one-chain kernel run on that chain with that key (one jitted step a
  style, compiled once in this module and called C times): SV csmc (PIT)
  and csmc-guided at T = 12, D = 3, N = 8; spatial kalman-1 (parallel),
  kalman-2 (sequential), csmc (PIT) and csmc-guided at T = 12 on the 3 x 3
  grid (d = 9), N = 8; the cSMC styles with and without the gradient shift.
  JAX runs its default CPU path (the generic forward and backward loops for
  the guided styles: its block-lane oracle `block_lane_scan_xla` computes in
  float32 whatever its inputs). Held: states to rtol 1e-9, identical
  trajectory indices (`updated`) and accept decisions;
- against the one-chain port: the batched step equals `chain_loop` of the
  one-chain kernel given the same noise bit for bit, and at C = 1 equals
  the one-chain kernel bit for bit; a step calls each sweep, scan and
  stitching kernel as often at C = 3 as at C = 1;
- the drivers with `--n-chains 2` run every style in scope as one batched
  step (`chain_loop` never called), and the options that once looped
  (ancestor scanning, systematic resampling, the PIT's blocked route, the
  guided style past the block-lane sweep's N) build the batched kernel too
  (their parity with JAX: `tests/test_torch_scan_chains.py` and
  `tests/test_torch_blocked_pit_chains.py`);
- `convert`'s chain-batched cSMC state both ways.
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
from aux_ssm_tpu.parallel.chains import chain_keys  # noqa: E402
from aux_ssm_tpu_torch import convert  # noqa: E402
from aux_ssm_tpu_torch.experiments import spatial as tsp_driver, sv as tsv_driver  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc as tcsmc, pit as tpit  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import CSMCState  # noqa: E402
from aux_ssm_tpu_torch.models import spatial as tsp  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402
from aux_ssm_tpu_torch.parallel import chains as tchains  # noqa: E402
from test_torch_pit import jax_step_noise  # noqa: E402

C, T, N = 3, 12, 8
SV_ARGS, SV_D = (0.0, 0.9, 2.0, 0.25), 3
SP_ARGS = (0.3, 4.0, -0.25, 1, 3)  # sigma_x, nu, tau, r_y, grid side
f64 = jnp.float64

# (model, style, gradient) of every case in scope.
CASES = [("sv", "csmc", False), ("sv", "csmc", True), ("sv", "csmc-guided", False),
         ("sv", "csmc-guided", True), ("spatial", "kalman-1", False),
         ("spatial", "kalman-2", False), ("spatial", "csmc", False), ("spatial", "csmc", True),
         ("spatial", "csmc-guided", False), ("spatial", "csmc-guided", True)]
IDS = [f"{m}-{s}{'-grad' if g else ''}" for m, s, g in CASES]


def _t(z):
    return torch.as_tensor(np.array(z))


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _sv_eig():
    _, _, _, Q, _ = jsv.get_dynamics(*SV_ARGS, SV_D)
    return tuple(np.array(z) for z in jnp.linalg.eigh(Q)) * 2  # P0 = Q


@pytest.fixture(scope="module")
def data():
    xs, ys = jsv.get_data(jax.random.key(0), *SV_ARGS, SV_D, T)
    sp_xs, sp_ys = jsp.get_data(np.random.default_rng(2), SP_ARGS[0], SP_ARGS[3], SP_ARGS[2],
                                SP_ARGS[1], SP_ARGS[4], T)
    return {"sv": (np.array(xs), np.array(ys)), "spatial": (np.array(sp_xs), np.array(sp_ys))}


def _port(model, style, gradient, ys, chains):
    """The port's (init, kernel) of a case, one chain's or over the chain axis."""
    ys = _t(ys)
    if model == "sv":
        if style == "csmc":
            return tsv.get_csmc_kernel(ys, *SV_ARGS, N, parallel=True, gradient=gradient,
                                       chains=chains)
        return tsv.get_guided_csmc_kernel(ys, *SV_ARGS, N, backward=True, gradient=gradient,
                                          eig=_sv_eig(), chains=chains)
    if style.startswith("kalman"):
        return tsp.get_kalman_kernel(ys, *SP_ARGS, style == "kalman-1", order=int(style[-1]),
                                     chains=chains)
    get = tsp.get_csmc_kernel if style == "csmc" else tsp.get_guided_csmc_kernel
    kw = dict(parallel=True) if style == "csmc" else dict(backward=True)
    return get(ys, *SP_ARGS, N, gradient=gradient, chains=chains, **kw)


def _jax(model, style, gradient, ys):
    """The JAX package's one-chain (init, kernel) of a case."""
    ys = jnp.asarray(ys)
    if model == "sv":
        if style == "csmc":
            return jsv.get_csmc_kernel(ys, *SV_ARGS, N, parallel=True, gradient=gradient)
        return jsv.get_guided_csmc_kernel(ys, *SV_ARGS, N, backward=True, gradient=gradient)
    if style.startswith("kalman"):
        return jsp.get_kalman_kernel(ys, *SP_ARGS, style == "kalman-1", order=int(style[-1]))
    get = jsp.get_csmc_kernel if style == "csmc" else jsp.get_guided_csmc_kernel
    kw = dict(parallel=True) if style == "csmc" else dict(backward=True)
    return get(ys, *SP_ARGS, N, gradient=gradient, **kw)


def _jax_noise(style, key, d):
    """One chain's noise of one JAX step from its key, in the port's layout."""
    if style == "csmc":  # the PIT cSMC
        return jax_step_noise(key, T, N, d)
    if style.startswith("kalman"):
        aux_key, sample_key, accept_key = jax.random.split(key, 3)
        return tuple(_t(z) for z in (jax.random.normal(aux_key, (T, d, 1), f64),
                                     jax.random.normal(sample_key, (T, d, 1), f64),
                                     jax.random.uniform(accept_key, (), f64)))
    aux_key, inner = jax.random.split(key)  # csmc_aux.py, then csmc.py with backward sampling
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    return tuple(_t(z) for z in (
        jax.random.normal(aux_key, (T, d), f64), jax.random.normal(key_init, (N, d), f64),
        jax.random.uniform(key_res, (T - 1, N), f64),
        jax.random.normal(key_prop, (T - 1, N, d), f64),
        jax.random.uniform(key_anc, (T - 1,), f64), jax.random.uniform(key_bwd, (T,), f64)))


def _stack(noises):
    """C chains' noise (the one-chain layout, nested) on a leading chain axis."""
    first = noises[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([z[i] for z in noises]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(z) for z in noises])


def _start(model, style, xs):
    """C chains' starts (C, T, d[, 1]) near the simulated states, each its own,
    and their deltas ((C,) for kalman, (C, T) for cSMC)."""
    rng = np.random.default_rng(len(style))
    x0 = xs[None] + (0.1 if model == "sv" else 0.2) * rng.standard_normal((C,) + xs.shape)
    if style.startswith("kalman"):
        return x0[..., None], rng.uniform(0.03, 0.08, C)
    lo, hi = {("sv", "csmc"): (0.05, 0.4), ("sv", "csmc-guided"): (0.2, 1.0),
              ("spatial", "csmc"): (0.005, 0.05)}.get((model, style), (0.05, 0.3))
    return x0, rng.uniform(lo, hi, (C, T))


def _draw(style, x, gen):
    """The port's noise of one batched step, chain first, from `gen`."""
    kw = dict(generator=gen, dtype=x.dtype)
    if style.startswith("kalman"):
        return torch.randn(x.shape, **kw), torch.randn(x.shape, **kw), torch.rand(C, **kw)
    if style == "csmc":
        return ((torch.randn(x.shape, **kw), torch.randn(C, T, N, x.shape[-1], **kw))
                + tpit.draw_noise(T, N, x, gen, chains=C))
    return (torch.randn(x.shape, **kw),) + tcsmc.draw_noise(x, N, tcsmc.resampling_mod.multinomial,
                                                            gen)


@pytest.fixture(scope="module")
def jax_steps(data):
    """One jitted JAX one-chain step a case, compiled at its first call."""
    steps = {}

    def get(case):
        if case not in steps:
            model, style, gradient = case
            jinit, jkernel = _jax(model, style, gradient, data[model][1])
            steps[case] = (jinit, jax.jit(jkernel))
        return steps[case]
    return get


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_step_matches_jax_on_each_chain(data, jax_steps, case):
    model, style, gradient = case
    xs, ys = data[model]
    jinit, jstep = jax_steps(case)
    tinit, tkernel = _port(model, style, gradient, ys, chains=True)
    assert tkernel.chain_axis
    x0, delta = _start(model, style, xs)
    jstates = [jinit(jnp.asarray(x0[c])) for c in range(C)]
    if style.startswith("kalman"):
        tstate = tinit(_t(x0))
    else:
        tstate = convert.csmc_chains_from_numpy(x0, device="cpu", dtype=torch.float64)
    d = xs.shape[-1]
    moved = 0
    for step_key in jax.random.split(jax.random.key(17), 2):
        keys = chain_keys(step_key, C)
        jstates = [jstep(keys[c], jstates[c], jnp.asarray(delta[c])) for c in range(C)]
        noise = _stack([_jax_noise(style, keys[c], d) for c in range(C)])
        tstate = tkernel(tstate, _t(delta), noise=noise)
        for c in range(C):
            np.testing.assert_array_equal(tstate.updated[c].numpy(),
                                          np.asarray(jstates[c].updated))
            _close(tstate.x[c], jstates[c].x)
            moved += int(np.asarray(jstates[c].updated).sum())
    assert moved > 0  # the comparison saw moves, not only rejections


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_step_is_the_chain_loop_bit_for_bit(data, case):
    """The batched kernel against `chain_loop` of the one-chain kernel, given
    the same noise, over two steps; at C = 1 against the one-chain kernel."""
    model, style, gradient = case
    xs, ys = data[model]
    init1, kernel1 = _port(model, style, gradient, ys, chains=False)
    initC, kernelC = _port(model, style, gradient, ys, chains=True)
    x0, delta = (_t(z) for z in _start(model, style, xs))
    looped = tchains.chain_loop(kernel1)
    s_loop = tchains._stack_states([init1(x0[c]) for c in range(C)])
    s_batch = s_loop if not style.startswith("kalman") else initC(x0)
    if style.startswith("kalman"):
        assert torch.equal(s_batch.log_target, s_loop.log_target)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        noise = _draw(style, s_batch.x, gen)
        s_loop = looped(s_loop, delta, noise=noise)
        s_batch = kernelC(s_batch, delta, noise=noise)
        assert torch.equal(s_batch.x, s_loop.x) and torch.equal(s_batch.updated, s_loop.updated)
    one = kernel1(init1(x0[0]), delta[0], noise=tchains._map_state(lambda z: z[0], noise))
    first = kernelC(initC(x0[:1]), delta[:1], noise=tchains._map_state(lambda z: z[:1], noise))
    assert torch.equal(first.x[0], one.x) and torch.equal(first.updated[0], one.updated)


def _counting(monkeypatch):
    """Count the calls of every sweep, scan and stitching wrapper where the
    callers look them up."""
    F_mod = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")
    S_mod = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")
    calls = {}

    def count(mod, name):
        fn = getattr(mod, name)
        calls[name] = 0

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("forward_factor_scan", "backward_factor_scan", "block_lane_scan"):
        count(CF, name)
    for name in ("row_lse", "col_sample"):
        count(tpit.kernels, name)
    count(F_mod, "scalar_filter_scan")
    count(S_mod, "scalar_affine_scan")
    return calls


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_launches_a_step_do_not_grow_with_the_chains(data, monkeypatch, case):
    model, style, gradient = case
    xs, ys = data[model]
    init, kernel = _port(model, style, gradient, ys, chains=True)
    x0, delta = (_t(z) for z in _start(model, style, xs))
    calls = _counting(monkeypatch)
    seen = []
    for n in (1, C):
        state = init(x0[:n]) if style.startswith("kalman") else CSMCState(
            x=x0[:n], updated=torch.zeros(x0[:n].shape[:-1], dtype=torch.bool))
        for k in calls:
            calls[k] = 0
        kernel(state, delta[:n], generator=torch.Generator().manual_seed(n))
        seen.append(dict(calls))
    assert seen[0] == seen[1]
    want = {"kalman-1": {"scalar_filter_scan": 2, "scalar_affine_scan": 1},
            "kalman-2": {},  # sequential: the filter and the draw are step loops
            "csmc": {"row_lse": 4, "col_sample": 3},  # T = 12: four tree levels
            "csmc-guided": {"block_lane_scan": 1, "backward_factor_scan": 1}}[style]
    assert seen[0] == dict.fromkeys(calls, 0) | want


@pytest.mark.parametrize("model,style", [("sv", "csmc"), ("sv", "csmc-guided"),
                                         ("spatial", "kalman-1"), ("spatial", "kalman-2"),
                                         ("spatial", "csmc"), ("spatial", "csmc-guided")])
def test_drivers_run_the_chains_as_one_batched_step(monkeypatch, tmp_path, model, style):
    """`--n-chains 2` at the drivers' defaults: the kernel is marked
    `chain_axis`, `chain_loop` is never called, and the output holds the
    chains' split-R-hat."""
    monkeypatch.setattr(tchains, "chain_loop", lambda k: pytest.fail("chain_loop ran"))
    driver, size = ((tsv_driver, ["--D", "2"]) if model == "sv" else (tsp_driver, ["--D", "2"]))
    out = tmp_path / "out.npz"
    res = driver.main(["--style", style, "--platform", "cpu", "--T", "8", *size, "--N", "8",
                       "--burnin", "3", "--n-samples", "6", "--n-chains", "2", "--no-verbose",
                       "--out", str(out)])
    assert res.stats.step.shape == (2,) and out.exists()
    assert res.state.x.shape[:2] == (2, 8)


@pytest.mark.parametrize("options", [dict(backward=False), dict(resampling="systematic"),
                                     dict(parallel=True, N=4096), dict(N=2048, guided=True)])
def test_options_outside_the_chain_axis_keep_the_chain_loop(data, options):
    """The options that kept the chain loop before every path took the chain
    axis (ancestor scanning, systematic resampling, the PIT's blocked route
    at N = 4096, the guided style past the block-lane sweep's N) now build
    the kernel over the chain axis, marked `chain_axis`, and without
    `chains` the one-chain kernel, unmarked; the predicates that chose
    between them are gone."""
    ys = _t(data["sv"][1])
    opts = dict(options)
    n = opts.pop("N", N)
    for chains in (True, False):
        if opts.get("guided", False):
            _, kernel = tsv.get_guided_csmc_kernel(ys, *SV_ARGS, n, backward=True,
                                                   chains=chains)
        else:
            kw = {k: v for k, v in opts.items() if k != "guided"}
            kw.setdefault("backward", True)
            _, kernel = tsv.get_csmc_kernel(ys, *SV_ARGS, n, chains=chains, **kw)
        assert getattr(kernel, "chain_axis", False) == chains
    assert not hasattr(tcsmc, "takes_chain_axis") and not hasattr(tpit, "takes_chain_axis")


def test_csmc_chains_convert_round_trip():
    rng = np.random.default_rng(0)
    x, updated = rng.standard_normal((C, T, 2)), rng.uniform(size=(C, T)) < 0.5
    state = convert.csmc_chains_from_numpy(x, updated, device="cpu", dtype=torch.float64)
    assert state.x.shape == (C, T, 2) and state.updated.dtype == torch.bool
    back = convert.csmc_chains_to_numpy(state)
    np.testing.assert_array_equal(back["x"], x)
    np.testing.assert_array_equal(back["updated"], updated)
    fresh = convert.csmc_chains_from_numpy(x, device="cpu", dtype=torch.float32)
    assert fresh.x.dtype == torch.float32 and not fresh.updated.any()
    assert fresh.updated.shape == (C, T)
