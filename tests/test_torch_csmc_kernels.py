"""The plain versions of the three cSMC sweep kernels
(`aux_ssm_tpu_torch/ops/cuda/csmc_fwd.py`) against the JAX package.

- float64 against the XLA oracles (`factor_scan_xla` with and without PGAS,
  `backward_factor_scan_xla`): indices identical, log weights to rtol 1e-9
  (the same algebra in another summation order agrees to ~1e-14).
- float32 against the Pallas kernels run with `interpret=True`, at the sizes
  `tests/test_csmc_fwd.py` uses: the two sides take prefix sums in other
  orders, so an index may flip where a uniform falls within rounding of a
  CDF step; > 99.5% of indices must agree and log weights to 2e-4 where
  they do (the JAX package's own bound between its kernel and oracle).
  Each step of the port starts from the Pallas kernel's previous step (its
  weights, index or particles): one flip changes every later weight, so
  free-running float32 sweeps drift apart (at N=2048 the Pallas kernel and
  its own XLA oracle agree on 99.3% of these inputs' ancestors), while a
  re-synced step isolates the kernel's own rounding.
- The block-lane sweep with the SV guided model: `block_lane_scan_xla` and
  the Pallas kernel compute in float32 whatever their inputs, so the
  float64 check holds the port's sweep against JAX's generic forward pass
  (the same proposal and weight per step, given the same noise), and the
  float32 check against the Pallas kernel and `block_lane_scan_xla`.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import csmc as jcsmc  # noqa: E402
from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu.ops import resampling as jres  # noqa: E402
from aux_ssm_tpu.ops.pallas import csmc_fwd as jcf  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc as tcsmc  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import tree_map  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops import resampling as tres  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402

NU, PHI, TAU, RHO = 0.0, 0.9, 2.0, 0.25


def _factor_inputs(T, N, k, seed):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.1, 1.0, N)
    return (0.5 * rng.standard_normal((T - 1, N, k)), 0.5 * rng.standard_normal((T - 1, N, k)),
            rng.standard_normal((T - 1, N)), rng.standard_normal((T - 1, N)),
            rng.uniform(size=(T - 1, N)), rng.uniform(size=T - 1), w0 / w0.sum())


def _agree_f32(anc_got, anc_want, lw_got=None, lw_want=None):
    agree = np.asarray(anc_got) == np.asarray(anc_want)
    assert agree.mean() > 0.995, agree.mean()
    if lw_got is not None:
        np.testing.assert_allclose(np.asarray(lw_got)[agree], np.asarray(lw_want)[agree],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("T,N,k", [(24, 16, 2), (24, 200, 3), (6, 2048, 2)])
def test_forward_factor_matches_xla_oracle_f64(pgas, T, N, k):
    inputs = _factor_inputs(T, N, k, seed=N)
    lw, anc = CF.forward_factor_scan(*(torch.as_tensor(z) for z in inputs), pgas=pgas)
    lw_x, anc_x = jcf.factor_scan_xla(*(jnp.asarray(z) for z in inputs), pgas=pgas)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_x))
    np.testing.assert_allclose(lw.numpy(), np.asarray(lw_x), rtol=1e-9, atol=1e-11)


def _carry(lw):
    w = torch.exp(lw - lw.max())
    return w / w.sum()


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("T,N", [(24, 32), (24, 200), (6, 2048)])
def test_forward_factor_matches_pallas_interpret_f32(pgas, T, N):
    inputs = [np.asarray(z, np.float32) for z in _factor_inputs(T, N, 2, seed=N)]
    lw_p, anc_p = jcf.fused_forward_scan(*(jnp.asarray(z) for z in inputs), pgas=pgas,
                                         interpret=True)
    rf, cf, rb, cb, res_u, anc_u, w0 = (torch.as_tensor(z) for z in inputs)
    lw_ref = torch.as_tensor(np.array(lw_p))
    steps = [CF.forward_factor_scan(rf[t:t + 1], cf[t:t + 1], rb[t:t + 1], cb[t:t + 1],
                                    res_u[t:t + 1], anc_u[t:t + 1],
                                    w0 if t == 0 else _carry(lw_ref[t - 1]), pgas=pgas)
             for t in range(T - 1)]
    _agree_f32(torch.cat([a for _, a in steps]), anc_p, torch.cat([lw for lw, _ in steps]),
               lw_p)


@pytest.mark.parametrize("T,N,k", [(20, 16, 3), (20, 64, 3), (6, 2048, 1)])
def test_backward_factor_matches_xla_oracle_f64_and_pallas_f32(T, N, k):
    rf, cf, rb, lw, _, us, _ = _factor_inputs(T, N, k, seed=k + N)
    b_T = 3
    got = CF.backward_factor_scan(*(torch.as_tensor(z) for z in (rf, cf, rb, lw, us)),
                                  torch.tensor(b_T))
    want = jcf.backward_factor_scan_xla(*(jnp.asarray(z) for z in (rf, cf, rb, lw, us)),
                                        jnp.int32(b_T))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    f32 = [np.asarray(z, np.float32) for z in (rf, cf, rb, lw, us)]
    want32 = np.asarray(jcf.fused_backward_scan(*(jnp.asarray(z) for z in f32), jnp.int32(b_T),
                                                interpret=True))
    t32 = [torch.as_tensor(z) for z in f32]
    nxt = np.append(want32[1:], b_T)  # each step from the Pallas kernel's next index
    got32 = [CF.backward_factor_scan(*(z[t:t + 1] for z in t32), torch.tensor(int(nxt[t])))
             for t in range(T - 1)]
    _agree_f32(torch.cat(got32), want32)


def _guided(T, D, seed, dtype):
    """The guided SV model on both sides (JAX's eigenbasis for the port)."""
    _, ys = jsv.get_data(jax.random.key(seed), NU, PHI, TAU, RHO, D, T)
    _, _, _, Q, _ = jsv.get_dynamics(NU, PHI, TAU, RHO, D)
    eig = tuple(np.array(z) for z in jnp.linalg.eigh(Q)) * 2   # P0 = Q
    rng = np.random.default_rng(seed + 1)
    u = rng.standard_normal((T, D))
    scale = rng.uniform(0.3, 0.6, size=T)
    jfac, _ = jsv.make_guided_factory(jnp.asarray(ys, dtype), NU, PHI, TAU, RHO)
    tfac, _ = tsv.make_guided_factory(torch.as_tensor(np.array(ys)).to(dtype_map[dtype]),
                                      NU, PHI, TAU, RHO, eig=eig)
    return (jfac(jnp.asarray(u, dtype), jnp.asarray(scale, dtype)),
            tfac(torch.as_tensor(u).to(dtype_map[dtype]),
                 torch.as_tensor(scale).to(dtype_map[dtype])))


dtype_map = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def test_block_lane_matches_jax_generic_forward_f64():
    T, D, N = 12, 3, 16
    (jM0, jG0, jMt, jGt), (tM0, tG0, tMt, tGt) = _guided(T, D, seed=4, dtype=jnp.float64)
    x_star = np.linspace(-0.5, 0.5, T * D).reshape(T, D)
    key = jax.random.key(9)
    key_init, key_res, key_prop, key_anc = jax.random.split(key, 4)
    noise = (jax.random.normal(key_init, (N, D)),
             jax.random.uniform(key_res, (T - 1, N), jnp.float64),
             jax.random.normal(key_prop, (T - 1, N, D), jnp.float64),
             jax.random.uniform(key_anc, (T - 1,), jnp.float64))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AUX_SSM_FUSED_CSMC", "0")
        want = jcsmc.forward_pass(key, jnp.asarray(x_star), jM0, jG0, jMt, jGt, N,
                                  jres.multinomial)
    got = tcsmc.forward_pass(torch.as_tensor(x_star), tM0, tG0, tMt, tGt, N, tres.multinomial,
                             tuple(torch.as_tensor(np.array(z)) for z in noise))
    w_T, xs, log_ws, anc = got
    np.testing.assert_array_equal(anc.numpy(), np.asarray(want[3]))
    for g, w in ((xs, want[1]), (log_ws, want[2]), (w_T, want[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-10)


def test_block_lane_matches_pallas_interpret_and_xla_f32():
    T, D, N = 12, 3, 16
    (_, _, jMt, jGt), (_, _, tMt, tGt) = _guided(T, D, seed=4, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    eps = rng.standard_normal((T - 1, D, N)).astype(np.float32)
    res_u = rng.uniform(size=(T - 1, N)).astype(np.float32)
    x_star = rng.standard_normal((T - 1, D)).astype(np.float32)
    x0 = rng.standard_normal((D, N)).astype(np.float32)
    w0 = np.full(N, 1.0 / N, np.float32)

    args = (jMt.block_propagate, jGt.block_logw, jMt.params, jGt.params, jMt.block_consts,
            jGt.block_consts) + tuple(jnp.asarray(z) for z in (eps, res_u, x_star, x0, w0))
    eps, res_u, x_star, x0, w0 = (torch.as_tensor(z) for z in (eps, res_u, x_star, x0, w0))
    for want in (jcf.block_lane_forward_scan(*args, interpret=True),
                 jcf.block_lane_scan_xla(*args)):
        xs_ref, lw_ref = (torch.as_tensor(np.array(z)) for z in want[:2])
        steps = []
        for t in range(T - 1):  # each step from the reference's particles and weights
            sl = slice(t, t + 1)
            mt = replace(tMt, params=tree_map(lambda z: z[sl], tMt.params))
            gt = replace(tGt, params=tree_map(lambda z: z[sl], tGt.params))
            steps.append(CF.block_lane_scan(mt, gt, eps[sl], res_u[sl], x_star[sl],
                                            x0 if t == 0 else xs_ref[t - 1],
                                            w0 if t == 0 else _carry(lw_ref[t - 1])))
        xs, lw, anc = (torch.cat(z) for z in zip(*steps))
        _agree_f32(anc, want[2], lw, want[1])
        rows = (anc.numpy() == np.asarray(want[2])).all(axis=1)
        np.testing.assert_allclose(xs.numpy()[rows], np.asarray(want[0])[rows],
                                   rtol=1e-4, atol=1e-4)


def test_block_lane_without_cuda_functor_raises_on_the_card(monkeypatch):
    """A model with block callables but no CUDA functor runs its plain
    version for CPU tensors; for CUDA tensors the wrapper raises instead of
    falling back (the dispatch is forced to the card's branch here)."""
    _, (_, _, tMt, tGt) = _guided(6, 2, seed=1, dtype=jnp.float64)

    class NoFunctor(type(tGt)):
        cuda_model = None

    gt = NoFunctor(params=tGt.params, c=tGt.c)
    n, d, N = 5, 2, 4
    args = (torch.zeros(n, d, N, dtype=torch.float64),
            torch.full((n, N), 0.5, dtype=torch.float64), torch.zeros(n, d, dtype=torch.float64),
            torch.zeros(d, N, dtype=torch.float64), torch.full((N,), 0.25, dtype=torch.float64))
    assert CF.block_lane_scan(tMt, gt, *args)[0].shape == (n, d, N)
    monkeypatch.setattr(CF, "_on_cuda", lambda name, ref: True)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        CF.block_lane_scan(tMt, gt, *args)
