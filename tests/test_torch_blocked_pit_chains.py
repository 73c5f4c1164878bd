"""C chains through the PIT cSMC's blocked stitching route as one batched
step (x with a leading chain axis of C = 3), float64 on the CPU:

- the plain chain twins of the two column draws (`ops.stitching.
  within_block_cols` and `stitch_draws` with `chains`): C = 1 equals the
  one-seed call, and chain c equals a one-chain call with seed[c], in f64
  and f32; the wrappers check that seeds and pairs make C chains;
- whole SV (D = 3) and spatial (3 x 3) `parallel=True` steps on the blocked
  route, forced at N = 128 and 256 (as `tests/test_torch_pit.py` forces it;
  JAX: AUX_SSM_STITCH=blocked), under both draws modes (JAX:
  AUX_SSM_STITCH_DRAWS): given each chain's noise as JAX draws it from its
  key (`chain_keys`), each chain equals the JAX one-chain step, states to
  rtol 1e-9 with identical `updated`; the batched step equals `chain_loop`
  of the one-chain kernel bit for bit, and at C = 1 the one-chain kernel;
- a step calls block_masses and its draw kernel once a level at C = 1 and at
  C = 3, and the builders mark the kernel `chain_axis`.

One jitted JAX step a case, compiled once in this module.
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
from aux_ssm_tpu_torch.kernels import pit as tpit  # noqa: E402
from aux_ssm_tpu_torch.models import spatial as tsp  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops import stitching as ST  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import stitching as KS  # noqa: E402
from aux_ssm_tpu_torch.parallel import chains as tchains  # noqa: E402
from test_torch_pit import jax_step_noise  # noqa: E402

C, T = 3, 6
SV_ARGS, SV_D = (0.0, 0.9, 2.0, 0.25), 3
SP_ARGS = (0.3, 4.0, -0.25, 1, 3)  # sigma_x, nu, tau, r_y, grid side
# (model, N, draws) of every whole-step case.
CASES = [("sv", 128, "joint"), ("sv", 128, "fused"), ("sv", 256, "joint"),
         ("sv", 256, "fused"), ("spatial", 128, "joint"), ("spatial", 128, "fused")]
IDS = [f"{m}-N{n}-{d}" for m, n, d in CASES]


def _t(z):
    return torch.as_tensor(np.array(z))


# --------------------------------------------------------------------------
# The plain chain twins of the two column draws
# --------------------------------------------------------------------------

def _draw_inputs(P, N, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    rf, cf = (torch.as_tensor(0.4 * rng.standard_normal((P, N, k)), dtype=dtype)
              for _ in range(2))
    cb = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype)
    Lb = ST.block_masses(rf, cf, cb)
    rl = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype) + torch.logsumexp(Lb, -1)
    u = torch.as_tensor(rng.uniform(size=(P, N)), dtype=dtype)
    blocks = torch.as_tensor(rng.integers(0, N // 128, (P, N)))
    return rf, cf, cb, Lb, rl, u, blocks


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("N,k", [(128, 1), (256, 3)])
def test_plain_draws_chain_c_is_a_one_chain_call_with_its_seed(dtype, N, k):
    per, offset = 2, 5
    rf, cf, cb, Lb, rl, u, blocks = _draw_inputs(C * per, N, k, dtype, N + k)
    seeds = torch.tensor([-7, 123456, 2 ** 31 - 2], dtype=torch.int32)
    cols = ST.within_block_cols(seeds, blocks, rf, cf, cb, offset, chains=C)
    rows_f, cols_f = ST.stitch_draws(seeds, rl, u, Lb, rf, cf, cb, offset, chains=C)
    for c in range(C):
        sl = slice(c * per, (c + 1) * per)
        one = ST.within_block_cols(int(seeds[c]), blocks[sl], rf[sl], cf[sl], cb[sl], offset)
        np.testing.assert_array_equal(cols[sl].numpy(), one.numpy())
        r1, c1 = ST.stitch_draws(int(seeds[c]), rl[sl], u[sl], Lb[sl], rf[sl], cf[sl], cb[sl],
                                 offset)
        np.testing.assert_array_equal(rows_f[sl].numpy(), r1.numpy())
        np.testing.assert_array_equal(cols_f[sl].numpy(), c1.numpy())
    # Another seed draws other columns: the chains' seeds reach the draws.
    assert not torch.equal(cols[:per], ST.within_block_cols(int(seeds[1]), blocks[:per],
                                                            rf[:per], cf[:per], cb[:per], offset))
    # C = 1: the one-seed call, through the wrapper (the CPU dispatch) too.
    for fn in (ST, KS):
        got = fn.within_block_cols(seeds[:1], blocks, rf, cf, cb, offset, chains=1)
        np.testing.assert_array_equal(
            got.numpy(), ST.within_block_cols(int(seeds[0]), blocks, rf, cf, cb, offset).numpy())
        got = fn.stitch_draws(seeds[:1], rl, u, Lb, rf, cf, cb, offset, chains=1)
        want = ST.stitch_draws(int(seeds[0]), rl, u, Lb, rf, cf, cb, offset)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_draw_wrappers_check_the_chains():
    rf, cf, cb, Lb, rl, u, blocks = _draw_inputs(4, 128, 2, torch.float64)
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="do not make 3 chains"):
        KS.within_block_cols(seeds, blocks, rf, cf, cb, chains=3)
    with pytest.raises(ValueError, match="do not make 2 chains"):
        KS.stitch_draws(seeds, rl, u, Lb, rf, cf, cb, chains=2)
    cols, extra = KS.within_block_cols(seeds[:2], blocks, rf, cf, cb, chains=2, col_extra=cf)
    np.testing.assert_array_equal(extra.numpy(), ST.take_rows(cf, cols).numpy())


# --------------------------------------------------------------------------
# Whole blocked steps over the chain axis
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    xs, ys = jsv.get_data(jax.random.key(1), *SV_ARGS, SV_D, T)
    sp_xs, sp_ys = jsp.get_data(np.random.default_rng(3), SP_ARGS[0], SP_ARGS[3], SP_ARGS[2],
                                SP_ARGS[1], SP_ARGS[4], T)
    return {"sv": (np.array(xs), np.array(ys)), "spatial": (np.array(sp_xs), np.array(sp_ys))}


def _port(model, N, ys, chains):
    ys = _t(ys)
    kw = dict(parallel=True, chains=chains)
    if model == "sv":
        init, kernel = tsv.get_csmc_kernel(ys, *SV_ARGS, N, **kw)
    else:
        init, kernel = tsp.get_csmc_kernel(ys, *SP_ARGS, N, **kw)
    return init, kernel


@pytest.fixture
def _blocked(monkeypatch):
    """JAX's environment for the blocked route; `_set_draws` picks the
    draws."""
    monkeypatch.setenv("AUX_SSM_STITCH", "blocked")
    return monkeypatch


def _set_draws(monkeypatch, draws):
    """Both sides on the blocked route with `draws`: JAX's by its
    environment, the port's builders through `csmc_independent.get_kernel`
    (they take the drivers' defaults, `stitch="auto"`)."""
    monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", draws)
    ind = importlib.import_module("aux_ssm_tpu_torch.kernels.csmc_independent")
    get = ind.get_kernel
    monkeypatch.setattr(ind, "get_kernel", lambda *a, **kw: get(
        *a, **{**kw, "stitch": "blocked", "draws": draws}))


@pytest.fixture(scope="module")
def jax_steps(data):
    steps = {}

    def get(case):
        if case not in steps:
            model, N, _ = case
            ys = jnp.asarray(data[model][1])
            if model == "sv":
                jinit, jkernel = jsv.get_csmc_kernel(ys, *SV_ARGS, N, parallel=True)
            else:
                jinit, jkernel = jsp.get_csmc_kernel(ys, *SP_ARGS, N, parallel=True)
            steps[case] = (jinit, jax.jit(jkernel))
        return steps[case]
    return get


def _start(model, xs):
    rng = np.random.default_rng(11)
    x0 = xs[None] + (0.1 if model == "sv" else 0.2) * rng.standard_normal((C,) + xs.shape)
    lo, hi = (0.05, 0.4) if model == "sv" else (0.005, 0.05)
    return x0, rng.uniform(lo, hi, (C, T))


def _stack(noises):
    first = noises[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([z[i] for z in noises]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(z) for z in noises])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_batched_step_matches_jax_on_each_chain(data, jax_steps, _blocked, case):
    model, N, draws = case
    _set_draws(_blocked, draws)
    xs, ys = data[model]
    jinit, jstep = jax_steps(case)
    _, tkernel = _port(model, N, ys, chains=True)
    assert tkernel.chain_axis
    x0, delta = _start(model, xs)
    jstates = [jinit(jnp.asarray(x0[c])) for c in range(C)]
    tstate = convert.csmc_chains_from_numpy(x0, device="cpu", dtype=torch.float64)
    d = xs.shape[-1]
    moved = 0
    for step_key in jax.random.split(jax.random.key(23), 2):
        keys = chain_keys(step_key, C)
        jstates = [jstep(keys[c], jstates[c], jnp.asarray(delta[c])) for c in range(C)]
        noise = _stack([jax_step_noise(keys[c], T, N, d) for c in range(C)])
        tstate = tkernel(tstate, _t(delta), noise=noise)
        for c in range(C):
            np.testing.assert_array_equal(tstate.updated[c].numpy(),
                                          np.asarray(jstates[c].updated))
            np.testing.assert_allclose(tstate.x[c].numpy(), np.asarray(jstates[c].x),
                                       rtol=1e-9, atol=1e-11)
            moved += int(np.asarray(jstates[c].updated).sum())
    assert moved > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_batched_step_is_the_chain_loop_bit_for_bit(data, _blocked, case):
    model, N, draws = case
    _set_draws(_blocked, draws)
    xs, ys = data[model]
    init1, kernel1 = _port(model, N, ys, chains=False)
    _, kernelC = _port(model, N, ys, chains=True)
    x0, delta = (_t(z) for z in _start(model, xs))
    s_loop = tchains._stack_states([init1(x0[c]) for c in range(C)])
    s_batch = s_loop
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        noise = ((torch.randn(x0.shape, generator=gen, dtype=x0.dtype),
                  torch.randn(C, T, N, x0.shape[-1], generator=gen, dtype=x0.dtype))
                 + tpit.draw_noise(T, N, x0, gen, chains=C))
        s_loop = tchains.chain_loop(kernel1)(s_loop, delta, noise=noise)
        s_batch = kernelC(s_batch, delta, noise=noise)
        assert torch.equal(s_batch.x, s_loop.x) and torch.equal(s_batch.updated, s_loop.updated)
    first = tchains._map_state(lambda z: z[:1], noise)
    one = kernel1(init1(x0[0]), delta[0], noise=tchains._map_state(lambda z: z[0], noise))
    batch1 = kernelC(init1(x0[:1]), delta[:1], noise=first)
    assert torch.equal(batch1.x[0], one.x) and torch.equal(batch1.updated[0], one.updated)


@pytest.mark.parametrize("draws", ["joint", "fused"])
def test_blocked_launches_a_step_do_not_grow_with_the_chains(data, _blocked, draws):
    _set_draws(_blocked, draws)
    xs, ys = data["sv"]
    _, kernel = _port("sv", 128, ys, chains=True)
    x0, delta = (_t(z) for z in _start("sv", xs))
    names = ("block_masses", "within_block_cols", "stitch_draws", "row_lse", "col_sample")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tpit.kernels, name)
        _blocked.setattr(tpit.kernels, name,
                         lambda *a, _f=fn, _n=name, **kw: calls.__setitem__(_n, calls[_n] + 1)
                         or _f(*a, **kw))
    seen = []
    for n in (1, C):
        state = convert.csmc_chains_from_numpy(x0[:n].numpy(), device="cpu",
                                               dtype=torch.float64)
        for k in calls:
            calls[k] = 0
        kernel(state, delta[:n], generator=torch.Generator().manual_seed(n))
        seen.append(dict(calls))
    assert seen[0] == seen[1]
    # T = 6: two levels below the root (blocked), the root by row_lse.
    draw = "within_block_cols" if draws == "joint" else "stitch_draws"
    assert seen[0] == dict.fromkeys(names, 0) | {"block_masses": 2, draw: 2, "row_lse": 1}
