"""Ancestor scanning, systematic resampling and the generic step loops over a
chain axis (C = 3), and theta-logistic PGAS as one batched step, float64 on
the CPU:

- the resampling schemes (`ops/resampling.py`) with a leading batch axis
  equal their one-row calls bit for bit, and JAX's one-row functions;
- SV auxiliary cSMC steps (T = 10, D = 3, N = 8) under the options that
  took one chain: ancestor scanning (`backward=False`), systematic
  resampling, and both generic loops (the factor sweeps switched off), for
  the sequential csmc style and for csmc-guided: given each chain's noise as
  JAX draws it from its key (`chain_keys`), each chain equals the JAX
  one-chain step (JAX's CPU path is its generic loops), states to rtol 1e-9
  with identical `updated`; the batched step equals `chain_loop` of the
  one-chain kernel bit for bit, and at C = 1 the one-chain kernel;
- theta-logistic PGAS (T = 12, N = 16) with `chains=True`, ancestor scanning
  and backward sampling: the same two checks against JAX's
  `get_pgas_kernel`, one lane sweep a step at C = 1 and C = 3, and the
  kernel marked `chain_axis`.

One jitted JAX step a case, compiled once in this module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu.models import theta_logistic as jtl  # noqa: E402
from aux_ssm_tpu.ops import resampling as jres  # noqa: E402
from aux_ssm_tpu.parallel.chains import chain_keys  # noqa: E402
from aux_ssm_tpu_torch import convert  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc as tcsmc  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.models import theta_logistic as ttl  # noqa: E402
from aux_ssm_tpu_torch.ops import resampling as tres  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402
from aux_ssm_tpu_torch.parallel import chains as tchains  # noqa: E402

C, T, N, D = 3, 10, 8, 3
SV_ARGS = (0.0, 0.9, 2.0, 0.25)
f64 = jnp.float64

# (style, options, generic): the SV cases; `generic` switches the factor
# sweeps off, so the generic forward and backward loops run.
SV_CASES = [("csmc", dict(backward=False), False),
            ("csmc", dict(backward=True, resampling="systematic"), False),
            ("csmc", dict(backward=False, resampling="systematic"), False),
            ("csmc", dict(backward=True), True),
            ("csmc-guided", dict(backward=False), False),
            ("csmc-guided", dict(backward=True, resampling="systematic"), False)]
SV_IDS = ["csmc-scan", "csmc-systematic", "csmc-scan-systematic", "csmc-generic",
          "guided-scan", "guided-systematic"]


def _t(z):
    return torch.as_tensor(np.array(z))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-11)


def _stack(noises):
    first = noises[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([z[i] for z in noises]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(z) for z in noises])


# --------------------------------------------------------------------------
# Resampling with a leading batch axis
# --------------------------------------------------------------------------

def test_resampling_batched_equals_each_row():
    rng = np.random.default_rng(0)
    M = 9
    w = rng.uniform(size=(C, M)) ** 3
    w[1, 0] = 0.0  # "at least one copy of particle 0" with w_0 underflowed
    w = torch.as_tensor(w / w.sum(-1, keepdims=True))
    u_n = torch.as_tensor(rng.uniform(size=(C, M)))
    u_3 = torch.as_tensor(rng.uniform(size=(C, 3)))
    u_1 = torch.as_tensor(rng.uniform(size=C))
    batched = (tres.multinomial_from_uniforms(u_n, w), tres.systematic_from_uniforms(u_3, w),
               tres.categorical_from_uniform(u_1, w), tres.choice_from_uniform(u_1, w))
    for c in range(C):
        rows = (tres.multinomial_from_uniforms(u_n[c], w[c]),
                tres.systematic_from_uniforms(u_3[c], w[c]),
                tres.categorical_from_uniform(u_1[c], w[c]),
                tres.choice_from_uniform(u_1[c], w[c]))
        for got, want in zip(batched, rows):
            assert torch.equal(got[c], want)
        jw = jnp.asarray(w[c].numpy())
        np.testing.assert_array_equal(
            batched[0][c].numpy(), np.asarray(jres.multinomial_from_uniforms(
                jnp.asarray(u_n[c].numpy()), jw)))
        np.testing.assert_array_equal(
            batched[1][c].numpy(), np.asarray(jres.systematic_from_uniforms(
                jnp.asarray(u_3[c].numpy()), jw)))
    assert int(batched[1][1, 0]) == 0 and batched[3].shape == (C, 1)


# --------------------------------------------------------------------------
# SV cSMC steps under the options that took one chain
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sv_data():
    xs, ys = jsv.get_data(jax.random.key(4), *SV_ARGS, D, T)
    return np.array(xs), np.array(ys)


def _sv_eig():
    _, _, _, Q, _ = jsv.get_dynamics(*SV_ARGS, D)
    return tuple(np.array(z) for z in jnp.linalg.eigh(Q)) * 2  # P0 = Q


def _sv_port(style, opts, ys, chains):
    if style == "csmc":
        return tsv.get_csmc_kernel(_t(ys), *SV_ARGS, N, chains=chains, **opts)
    return tsv.get_guided_csmc_kernel(_t(ys), *SV_ARGS, N, eig=_sv_eig(), chains=chains, **opts)


def _sv_jax(style, opts, ys):
    get = jsv.get_csmc_kernel if style == "csmc" else jsv.get_guided_csmc_kernel
    return get(jnp.asarray(ys), *SV_ARGS, N, **opts)


def _sv_jax_noise(key, opts):
    """One chain's noise of one JAX aux-cSMC step from its key (csmc_aux.py,
    then csmc.py), in the port's layout."""
    aux_key, inner = jax.random.split(key)
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    n_res = 3 if opts.get("resampling") == "systematic" else N
    if opts["backward"]:
        us = jax.random.uniform(key_bwd, (T,), f64)
    else:  # ancestor scanning: jax.random.choice's one uniform
        us = jnp.zeros(T, f64).at[-1].set(jax.random.uniform(key_bwd, (), f64))
    return tuple(_t(z) for z in (
        jax.random.normal(aux_key, (T, D), f64), jax.random.normal(key_init, (N, D), f64),
        jax.random.uniform(key_res, (T - 1, n_res), f64),
        jax.random.normal(key_prop, (T - 1, N, D), f64),
        jax.random.uniform(key_anc, (T - 1,), f64), us))


def _generic_loops(monkeypatch):
    """Switch the factor sweeps off: the generic forward and backward loops
    run."""
    monkeypatch.setattr(tcsmc, "_use_fused_forward", lambda *a: False)
    monkeypatch.setattr(tcsmc, "_use_fused_backward", lambda *a: False)


@pytest.fixture(scope="module")
def jax_steps(sv_data):
    steps = {}

    def get(i):
        if i not in steps:
            style, opts, _ = SV_CASES[i]
            jinit, jkernel = _sv_jax(style, opts, sv_data[1])
            steps[i] = (jinit, jax.jit(jkernel))
        return steps[i]
    return get


def _sv_start(xs, style):
    rng = np.random.default_rng(len(style))
    x0 = xs[None] + 0.1 * rng.standard_normal((C,) + xs.shape)
    lo, hi = (0.05, 0.4) if style == "csmc" else (0.2, 1.0)
    return x0, rng.uniform(lo, hi, (C, T))


@pytest.mark.parametrize("case", range(len(SV_CASES)), ids=SV_IDS)
def test_sv_batched_step_matches_jax_on_each_chain(sv_data, jax_steps, monkeypatch, case):
    style, opts, generic = SV_CASES[case]
    if generic:
        _generic_loops(monkeypatch)
    xs, ys = sv_data
    jinit, jstep = jax_steps(case)
    _, tkernel = _sv_port(style, opts, ys, chains=True)
    assert tkernel.chain_axis
    x0, delta = _sv_start(xs, style)
    jstates = [jinit(jnp.asarray(x0[c])) for c in range(C)]
    tstate = convert.csmc_chains_from_numpy(x0, device="cpu", dtype=torch.float64)
    moved = 0
    for step_key in jax.random.split(jax.random.key(31), 2):
        keys = chain_keys(step_key, C)
        jstates = [jstep(keys[c], jstates[c], jnp.asarray(delta[c])) for c in range(C)]
        tstate = tkernel(tstate, _t(delta),
                         noise=_stack([_sv_jax_noise(keys[c], opts) for c in range(C)]))
        for c in range(C):
            np.testing.assert_array_equal(tstate.updated[c].numpy(),
                                          np.asarray(jstates[c].updated))
            _close(tstate.x[c], jstates[c].x)
            moved += int(np.asarray(jstates[c].updated).sum())
    assert moved > 0


@pytest.mark.parametrize("case", range(len(SV_CASES)), ids=SV_IDS)
def test_sv_batched_step_is_the_chain_loop_bit_for_bit(sv_data, monkeypatch, case):
    style, opts, generic = SV_CASES[case]
    if generic:
        _generic_loops(monkeypatch)
    xs, ys = sv_data
    init1, kernel1 = _sv_port(style, opts, ys, chains=False)
    _, kernelC = _sv_port(style, opts, ys, chains=True)
    x0, delta = (_t(z) for z in _sv_start(xs, style))
    s_loop = s_batch = tchains._stack_states([init1(x0[c]) for c in range(C)])
    resample = tres.get(opts.get("resampling", "multinomial"))
    gen = torch.Generator().manual_seed(8)
    for _ in range(2):
        noise = ((torch.randn(x0.shape, generator=gen, dtype=x0.dtype),)
                 + tcsmc.draw_noise(x0, N, resample, gen))
        s_loop = tchains.chain_loop(kernel1)(s_loop, delta, noise=noise)
        s_batch = kernelC(s_batch, delta, noise=noise)
        assert torch.equal(s_batch.x, s_loop.x) and torch.equal(s_batch.updated, s_loop.updated)
    one = kernel1(init1(x0[0]), delta[0], noise=tchains._map_state(lambda z: z[0], noise))
    first = kernelC(init1(x0[:1]), delta[:1], noise=tchains._map_state(lambda z: z[:1], noise))
    assert torch.equal(first.x[0], one.x) and torch.equal(first.updated[0], one.updated)


def test_sv_scan_launches_do_not_grow_with_the_chains(sv_data, monkeypatch):
    """Ancestor scanning under the factor sweep: one forward sweep a step and
    no backward sweep, at C = 1 and C = 3."""
    xs, ys = sv_data
    _, kernel = _sv_port("csmc", dict(backward=False), ys, chains=True)
    calls = {"forward_factor_scan": 0, "backward_factor_scan": 0}
    for name in calls:
        fn = getattr(CF, name)
        monkeypatch.setattr(CF, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw))
    x0, delta = (_t(z) for z in _sv_start(xs, "csmc"))
    seen = []
    for n in (1, C):
        for k in calls:
            calls[k] = 0
        state = convert.csmc_chains_from_numpy(x0[:n].numpy(), device="cpu",
                                               dtype=torch.float64)
        out = kernel(state, delta[:n], generator=torch.Generator().manual_seed(n))
        assert out.x.shape == (n, T, D)
        seen.append(dict(calls))
    assert seen == [{"forward_factor_scan": 1, "backward_factor_scan": 0}] * 2


# --------------------------------------------------------------------------
# Theta-logistic PGAS over the chain axis
# --------------------------------------------------------------------------

TL_T, TL_N = 12, 16


@pytest.fixture(scope="module")
def tl_data():
    xs, ys = jtl.get_data(jax.random.key(2), TL_T)
    # JAX's lane oracle rounds the observations to float32: give both sides
    # values float32 holds (as tests/test_torch_theta_logistic.py does).
    return np.array(xs), np.asarray(ys, np.float32).astype(np.float64)


def _tl_jax_noise(key, backward):
    key_fwd, key_bwd = jax.random.split(key)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    if backward:
        us = jax.random.uniform(key_bwd, (TL_T,), f64)
    else:
        us = jnp.zeros(TL_T, f64).at[-1].set(jax.random.uniform(key_bwd, (), f64))
    return tuple(_t(z) for z in (
        jax.random.normal(key_init, (TL_N, 1), f64),
        jax.random.uniform(key_res, (TL_T - 1, TL_N), f64),
        jax.random.normal(key_prop, (TL_T - 1, TL_N, 1), f64),
        jax.random.uniform(key_anc, (TL_T - 1,), f64), us))


def _tl_start(xs):
    rng = np.random.default_rng(9)
    return xs[None] + 0.1 * rng.standard_normal((C,) + xs.shape)


@pytest.mark.parametrize("backward", [False, True], ids=["scan", "backward"])
def test_theta_logistic_pgas_chains_match_jax_on_each_chain(tl_data, monkeypatch, backward):
    xs, ys = tl_data
    jinit, jkernel = jtl.get_pgas_kernel(jnp.asarray(ys), TL_N, backward=backward)
    _, tkernel = ttl.get_pgas_kernel(_t(ys), TL_N, backward=backward, chains=True)
    assert tkernel.chain_axis
    lane_calls = []
    lane_scan = CF.lane_scan
    monkeypatch.setattr(CF, "lane_scan", lambda *a: lane_calls.append(a[3].shape) or
                        lane_scan(*a))
    jstep = jax.jit(jkernel)
    x0 = _tl_start(xs)
    jstates = [jinit(jnp.asarray(x0[c])) for c in range(C)]
    tstate = convert.csmc_chains_from_numpy(x0, device="cpu", dtype=torch.float64)
    moved = 0
    for step_key in jax.random.split(jax.random.key(12), 2):
        keys = chain_keys(step_key, C)
        jstates = [jstep(keys[c], jstates[c]) for c in range(C)]
        tstate = tkernel(tstate, noise=_stack([_tl_jax_noise(keys[c], backward)
                                               for c in range(C)]))
        for c in range(C):
            np.testing.assert_array_equal(tstate.updated[c].numpy(),
                                          np.asarray(jstates[c].updated))
            _close(tstate.x[c], jstates[c].x)
            moved += int(np.asarray(jstates[c].updated).sum())
    assert moved > 0
    # One lane sweep a step for the three chains (eps (C, T-1, N)).
    assert lane_calls == [(C, TL_T - 1, TL_N)] * 2


@pytest.mark.parametrize("backward", [False, True], ids=["scan", "backward"])
def test_theta_logistic_pgas_chains_are_the_chain_loop_bit_for_bit(tl_data, backward):
    xs, ys = tl_data
    init1, kernel1 = ttl.get_pgas_kernel(_t(ys), TL_N, backward=backward)
    _, kernelC = ttl.get_pgas_kernel(_t(ys), TL_N, backward=backward, chains=True)
    x0 = _t(_tl_start(xs))
    s_loop = s_batch = tchains._stack_states([init1(x0[c]) for c in range(C)])
    looped = tchains.chain_loop(lambda s, d, generator=None, noise=None:
                                kernel1(s, generator=generator, noise=noise))
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        noise = tcsmc.draw_noise(x0, TL_N, tres.multinomial, gen)
        s_loop = looped(s_loop, torch.zeros(C), noise=noise)
        s_batch = kernelC(s_batch, noise=noise)
        assert torch.equal(s_batch.x, s_loop.x) and torch.equal(s_batch.updated, s_loop.updated)
    one = kernel1(init1(x0[0]), noise=tchains._map_state(lambda z: z[0], noise))
    first = kernelC(init1(x0[:1]), noise=tchains._map_state(lambda z: z[:1], noise))
    assert torch.equal(first.x[0], one.x) and torch.equal(first.updated[0], one.updated)
    assert not getattr(kernel1, "chain_axis", False)


def test_theta_logistic_unit_chain_params_reach_the_lane_sweep(tl_data):
    """The shared params carry a unit chain axis (1, T-1, ...); the lane
    sweep takes them as every chain's (`csmc_fwd._for_chains`)."""
    _, ys = tl_data
    _, _, Mt, Gt = ttl.get_feynman_kac(_t(ys), chains=True)
    assert Gt.params.shape == (1, TL_T - 1, 1) and Mt.params.shape == (1, TL_T - 1, 0)
    expanded = CF._for_chains(Gt.params, C)
    assert expanded.shape == (C, TL_T - 1, 1) and expanded.stride(0) == 0
