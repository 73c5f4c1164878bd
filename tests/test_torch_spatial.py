"""The port's spatio-temporal Student-t model against the JAX package's:
the precision matrices and the stencil (exact), the t density and the stencil
apply (1e-12), the potential's gradient in closed form against `jax.grad`
(1e-10), the simulation draw for draw, one whole step of every sampler style
given the noise JAX draws (float64, rtol 1e-9, acceptances and picked indices
identical), the guided (B, N)-block path against `block_lane_scan_xla`, the
dispatch of each style to its sweep, and `init_x_fn` in law.

JAX runs its generic loops here (no TPU): `associative_scan` for the batched
scalar filters, the step loop for the guided sweep. The port takes the scalar
scans' plain versions (kalman), the factor sweeps (csmc) and the block-lane
sweep with the dense precision (csmc-guided). `block_lane_scan_xla` casts the
precision and every input to float32, so that comparison runs in float32,
step by step from the oracle's own carry.
"""
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import spatial as jsp  # noqa: E402
from aux_ssm_tpu.models import t_distribution as jtd  # noqa: E402
from aux_ssm_tpu.native import precision as jprec  # noqa: E402
from aux_ssm_tpu.ops.pallas import csmc_fwd as jcf  # noqa: E402
from aux_ssm_tpu_torch import spatial_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import tree_map  # noqa: E402
from aux_ssm_tpu_torch.models import spatial as tsp  # noqa: E402
from aux_ssm_tpu_torch.models import t_distribution as ttd  # noqa: E402
from aux_ssm_tpu_torch.native import precision as tprec  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402

SIG_X, NU, TAU, R_Y, D = 0.5, 4.0, -0.25, 1, 3
B, N = D * D, 16
f64 = jnp.float64
CPU = dict(device="cpu", dtype=torch.float64)


def _t(z):
    return torch.as_tensor(np.array(z))


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _data(T, seed=2):
    xs, ys = jsp.get_data(np.random.default_rng(seed), SIG_X, R_Y, TAU, NU, D, T)
    return xs, ys


@pytest.mark.parametrize("tau,r_y,d", [(-0.25, 1, 2), (-0.25, 1, 8), (0.3, 2, 5), (-0.1, 1.0, 3)])
def test_precision_matrices_match_jax(tau, r_y, d):
    for got, want in zip(tprec.make_precision_coo(tau, r_y, d),
                         jprec._coo_numpy(tau, r_y, d)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tprec.make_precision_dense(tau, r_y, d),
                                  jprec.make_precision_dense(tau, r_y, d))
    np.testing.assert_array_equal(tprec.precision_stencil(tau, r_y),
                                  jprec.precision_stencil(tau, r_y))


def test_t_distribution_matches_jax():
    rng = np.random.default_rng(0)
    stencil = jprec.precision_stencil(TAU, R_Y)
    prec = jprec.make_precision_dense(TAU, R_Y, D)
    v = rng.standard_normal((7, 5, B))
    _close(ttd.apply_precision_stencil(_t(v), _t(stencil), D),
           jtd.apply_precision_stencil(jnp.asarray(v), jnp.asarray(stencil), D))
    _close(ttd.apply_precision_stencil(_t(v), _t(stencil), D), v @ prec.T, atol=1e-12)
    x, mu = rng.standard_normal((10, B)), rng.standard_normal(B)
    want = jtd.logpdf(jnp.asarray(x), jnp.asarray(mu), NU, stencil=jnp.asarray(stencil), d=D)
    _close(ttd.logpdf(_t(x), _t(mu), NU, stencil=_t(stencil), d=D), want)
    _close(ttd.logpdf(_t(x), _t(mu), NU, prec=_t(prec)), want)
    _close(ttd.quad_form_stencil(_t(x), _t(mu), _t(stencil), D),
           jtd.quad_form_stencil(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(stencil), D))


def test_t_sample_moments_in_law():
    """Mean mu and covariance nu / (nu - 2) P^{-1}; 40000 draws put the
    entries' standard errors near 0.01."""
    prec = tprec.make_precision_dense(TAU, R_Y, 2)
    chol_prec = _t(np.linalg.cholesky(prec).T)  # upper
    mu = torch.arange(4.0, dtype=torch.float64)
    draws = ttd.sample(mu, 5.0, chol_prec, n=40_000, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (40_000, 4)
    np.testing.assert_allclose(draws.mean(0).numpy(), mu.numpy(), atol=0.05)
    np.testing.assert_allclose(np.cov(draws.numpy().T), 5.0 / 3.0 * np.linalg.inv(prec), atol=0.1)
    one = ttd.sample(mu, 5.0, chol_prec, generator=torch.Generator().manual_seed(1))
    assert one.shape == (4,) and bool(torch.isfinite(one).all())


def test_dynamics_data_and_potential_match_jax():
    for got, want in zip(tsp.get_dynamics(SIG_X, D, **CPU), jsp.get_dynamics(SIG_X, D)):
        _close(got, want)
    T = 12
    xs, ys = _data(T)
    txs, tys = tsp.get_data(np.random.default_rng(2), SIG_X, R_Y, TAU, NU, D, T, **CPU)
    np.testing.assert_array_equal(txs.numpy(), xs)  # the same NumPy draws
    np.testing.assert_array_equal(tys.numpy(), ys)
    stencil = jprec.precision_stencil(TAU, R_Y)
    x = xs + 0.3 * np.random.default_rng(3).standard_normal((T, B))
    _close(tsp.log_potential_one(_t(x), _t(ys), NU, _t(stencil), D),
           jsp.log_potential_one(jnp.asarray(x), jnp.asarray(ys), NU, jnp.asarray(stencil), D))
    _close(float(tsp.log_potential(_t(x), _t(ys), NU, _t(stencil), D)),
           float(jsp.log_potential(jnp.asarray(x), jnp.asarray(ys), NU, jnp.asarray(stencil), D)))
    want = jax.grad(lambda z: jsp.log_potential(z, jnp.asarray(ys), NU, jnp.asarray(stencil), D))(
        jnp.asarray(x))
    _close(tsp.grad_log_potential_one(_t(x), _t(ys), NU, _t(stencil), D), want, rtol=1e-10)
    v = _t(x).requires_grad_(True)  # and through autograd, as the csmc gradient shift takes it
    (g,) = torch.autograd.grad(tsp.log_potential(v, _t(ys), NU, _t(stencil), D), v)
    _close(g, want, rtol=1e-10)


def test_spatial_from_numpy():
    xs, ys = _data(6)
    for dtype in (torch.float32, torch.float64):
        y, x, x0 = spatial_from_numpy(ys, xs, xs + 1.0, device="cpu", dtype=dtype)
        assert y.dtype == x.dtype == x0.dtype == dtype and y.shape == (6, B)
        np.testing.assert_array_equal(y.numpy(), ys.astype(y.numpy().dtype))
    assert spatial_from_numpy(ys, device="cpu", dtype=torch.float64)[1:] == (None, None)


# --------------------------------------------------------------------------
# Whole steps given JAX's noise
# --------------------------------------------------------------------------

def _kalman_noise(key, T):
    aux_key, sample_key, accept_key = jax.random.split(key, 3)
    return (jax.random.normal(aux_key, (T, B, 1), f64),
            jax.random.normal(sample_key, (T, B, 1), f64),
            jax.random.uniform(accept_key, (), f64))


def _csmc_noise(key, T):
    """Every random number of one JAX aux-cSMC step (backward sampling), as
    csmc_aux.py and csmc.py draw them from `key`."""
    aux_key, inner = jax.random.split(key)
    key_fwd, key_bwd = jax.random.split(inner)
    key_init, key_res, key_prop, key_anc = jax.random.split(key_fwd, 4)
    return (jax.random.normal(aux_key, (T, B), f64), jax.random.normal(key_init, (N, B), f64),
            jax.random.uniform(key_res, (T - 1, N), f64),
            jax.random.normal(key_prop, (T - 1, N, B), f64),
            jax.random.uniform(key_anc, (T - 1,), f64), jax.random.uniform(key_bwd, (T,), f64))


def _kernels(style, ys):
    jys, tys = jnp.asarray(ys), _t(ys)
    gradient = style.endswith("-grad")
    if style.startswith("kalman"):
        order = int(style[-1])
        return (jsp.get_kalman_kernel(jys, SIG_X, NU, TAU, R_Y, D, True, order=order),
                tsp.get_kalman_kernel(tys, SIG_X, NU, TAU, R_Y, D, True, order=order),
                _kalman_noise)
    get_j, get_t = ((jsp.get_guided_csmc_kernel, tsp.get_guided_csmc_kernel)
                    if style.startswith("csmc-guided") else
                    (jsp.get_csmc_kernel, tsp.get_csmc_kernel))
    return (get_j(jys, SIG_X, NU, TAU, R_Y, D, N, backward=True, gradient=gradient),
            get_t(tys, SIG_X, NU, TAU, R_Y, D, N, backward=True, gradient=gradient), _csmc_noise)


def _counting(monkeypatch):
    """Count the calls of every sweep and scan wrapper, where the callers
    look them up."""
    F_mod = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")  # `ops` exports
    S_mod = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")   # functions of these names
    calls = {}

    def count(mod, name):
        fn = getattr(mod, name)
        calls[name] = 0

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("forward_factor_scan", "backward_factor_scan", "block_lane_scan", "lane_scan"):
        count(CF, name)
    count(F_mod, "scalar_filter_scan")
    count(S_mod, "scalar_affine_scan")
    count(F_mod, "filter_scan")
    count(S_mod, "affine_scan")
    return calls


@pytest.mark.parametrize("T", [8, 24])
@pytest.mark.parametrize("style", ["kalman-1", "kalman-2", "csmc", "csmc-grad", "csmc-guided",
                                   "csmc-guided-grad"])
def test_step_matches_jax_given_noise(monkeypatch, style, T):
    xs, ys = _data(T, seed=T)
    (jinit, jkernel), (tinit, tkernel), draw = _kernels(style, ys)
    calls = _counting(monkeypatch)
    x0 = xs + 0.2 * np.random.default_rng(1).standard_normal((T, B))
    delta = np.random.default_rng(T).uniform(0.05, 0.3, T) if "csmc" in style else 0.05
    _, _, tx0 = spatial_from_numpy(ys, None, x0, **CPU)
    jstate, tstate = jinit(jnp.asarray(x0)), tinit(tx0)
    jstep = jax.jit(lambda k, s: jkernel(k, s, jnp.asarray(delta)))
    keys = jax.random.split(jax.random.key(11), 3)
    moved = 0
    for key in keys:
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, _t(delta), noise=tuple(_t(z) for z in draw(key, T)))
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        _close(tstate.x, jstate.x, rtol=1e-9, atol=1e-11)
        moved += int(np.asarray(jstate.updated).sum())
    assert moved > 0  # the comparison saw accepted proposals, not three rejections
    n = len(keys)
    want = {"kalman": {"scalar_filter_scan": 2 * n, "scalar_affine_scan": n},
            "csmc": {"forward_factor_scan": n, "backward_factor_scan": n},
            "csmc-guided": {"block_lane_scan": n, "backward_factor_scan": n}}[
                style.removesuffix("-grad").removesuffix("-1").removesuffix("-2")]
    assert calls == dict.fromkeys(calls, 0) | want


def test_parallel_csmc_is_not_ported(monkeypatch):
    """`parallel=True` was not ported; it is the PIT cSMC now: a step at T=6
    (three tree levels) calls row_lse at each and runs neither sequential
    sweep."""
    xs, ys = _data(6)
    from aux_ssm_tpu_torch.kernels import pit
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd
    calls = []
    row_lse = pit.kernels.row_lse
    monkeypatch.setattr(pit.kernels, "row_lse", lambda *a: calls.append(1) or row_lse(*a))
    for name in ("forward_factor_scan", "backward_factor_scan"):
        monkeypatch.setattr(csmc_fwd, name, lambda *a, **k: pytest.fail("a sequential sweep ran"))
    init, kernel = tsp.get_csmc_kernel(_t(ys), SIG_X, NU, TAU, R_Y, D, N, parallel=True)
    state = kernel(init(_t(xs)), torch.full((6,), 0.05, dtype=torch.float64),
                   generator=torch.Generator().manual_seed(0))
    assert calls == [1, 1, 1] and state.x.shape == xs.shape
    assert bool(torch.isfinite(state.x).all())


def test_kalman_kernel_checks_the_grid():
    _, ys = _data(6)
    with pytest.raises(ValueError, match="d \\* d"):
        tsp.get_kalman_kernel(_t(ys), SIG_X, NU, TAU, R_Y, D + 1, True)


# --------------------------------------------------------------------------
# The guided (B, N)-block path
# --------------------------------------------------------------------------

def _grid(z):
    """z rounded to multiples of 1/64: differences of such values times the
    precision's entries (1, -0.25, 0) and their row sums are exact in float32,
    so JAX's float32 products P (y - x) lose nothing."""
    return np.round(np.asarray(z) * 64.0) / 64.0


def _guided(T, gradient, dtype):
    """The guided model's (Mt, Gt) on both sides at the same u and scale.
    JAX builds its classes inside `get_guided_csmc_kernel`; the factory is
    taken from where `csmc_aux.get_kernel` receives it."""
    ys = _grid(_data(T, seed=5)[1])
    rng = np.random.default_rng(6)
    u = (ys + 0.3 * rng.standard_normal((T, B))).astype(dtype)
    scale = rng.uniform(0.2, 0.5, size=T).astype(dtype)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsp.csmc_aux, "get_kernel",
                   lambda factory, *a, **k: captured.setdefault("factory", factory))
        jsp.get_guided_csmc_kernel(jnp.asarray(ys.astype(dtype)), SIG_X, NU, TAU, R_Y, D, N,
                                   gradient=gradient)
    tfac, _ = tsp.make_guided_factory(_t(ys.astype(dtype)), SIG_X, NU, TAU, R_Y, D, gradient)
    return (captured["factory"](jnp.asarray(u), jnp.asarray(scale))[2:],
            tfac(_t(u), _t(scale))[2:])


@pytest.mark.parametrize("gradient", [False, True])
def test_guided_callables_match_jax(gradient):
    """Row forms ((N, B) particles, the stencil) and block forms ((B, N)
    blocks, the dense precision) of the proposal and the weight, float64.
    JAX's block forms multiply by the precision in float32 whatever their
    inputs' type (the port computes in the tensors' type), so the particles
    and the data lie on a grid where those products are exact (`_grid`)."""
    T = 6
    (jMt, jGt), (tMt, tGt) = _guided(T, gradient, np.float64)
    rng = np.random.default_rng(7)
    x, x_next, eps = rng.standard_normal((3, N, B))
    x, x_next = _grid(x), _grid(x_next)
    t = 2
    jp = jax.tree.map(lambda z: z[t], jMt.params)
    tp = tuple(p[t] for p in tMt.params)
    _close(tMt.sample_from_noise(_t(eps), _t(x), tp), jMt.sample_from_noise(eps, x, jp),
           rtol=1e-11)
    _close(tGt(_t(x_next), _t(x), tp), jGt(x_next, x, jp), rtol=1e-11)
    jblk = tuple(z[:, None] if z.ndim else z for z in jp)  # (B, 1) columns, scalar scale
    _close(tMt.block_propagate(_t(eps.T), _t(x.T), tp),
           jMt.block_propagate(eps.T, x.T, jblk, jMt.block_consts), rtol=1e-11)
    _close(tGt.block_logw(_t(x_next.T), _t(x.T), tp),
           jGt.block_logw(x_next.T, x.T, jblk, jGt.block_consts)[0], rtol=1e-11)
    _close(tGt.block_logw(_t(x_next.T), _t(x.T), tp), tGt(_t(x_next), _t(x), tp), rtol=1e-11)


@pytest.mark.parametrize("gradient", [False, True])
def test_block_lane_matches_xla_oracle_f32(gradient):
    """The port's plain block-lane sweep against `block_lane_scan_xla`, both
    in float32, each step from the oracle's own particles and weights: the
    JAX package's own bound between kernel and oracle (>= 99.5% of ancestors
    equal, weights within 2e-4 where they are)."""
    T = 12
    (jMt, jGt), (tMt, tGt) = _guided(T, gradient, np.float32)
    rng = np.random.default_rng(8)
    n = T - 1
    eps = rng.standard_normal((n, B, N)).astype(np.float32)
    res_u = rng.uniform(size=(n, N)).astype(np.float32)
    x_star = np.asarray(tMt.params[2][:, :].numpy() + 0.2 * rng.standard_normal((n, B)), np.float32)
    x0 = np.asarray(tMt.params[2][0].numpy()[:, None] + 0.3 * rng.standard_normal((B, N)),
                    np.float32)
    w0 = np.full(N, 1.0 / N, np.float32)
    want = jcf.block_lane_scan_xla(
        jMt.block_propagate, jGt.block_logw, jMt.params, jGt.params, jMt.block_consts,
        jGt.block_consts, *(jnp.asarray(z) for z in (eps, res_u, x_star, x0, w0)))
    xs_ref, lw_ref = (_t(z) for z in want[:2])
    eps, res_u, x_star, x0, w0 = (torch.as_tensor(z) for z in (eps, res_u, x_star, x0, w0))
    steps = []
    for t in range(n):
        sl = slice(t, t + 1)
        mt = replace(tMt, params=tree_map(lambda z: z[sl], tMt.params))
        gt = replace(tGt, params=tree_map(lambda z: z[sl], tGt.params))
        w = torch.exp(lw_ref[t - 1] - lw_ref[t - 1].max()) if t else w0
        steps.append(CF.block_lane_scan(mt, gt, eps[sl], res_u[sl], x_star[sl],
                                        x0 if t == 0 else xs_ref[t - 1], w / w.sum()))
    xs, lw, anc = (torch.cat(z) for z in zip(*steps))
    assert xs.dtype == torch.float32
    same = anc.numpy() == np.asarray(want[2])
    assert same.mean() >= 0.995
    assert len(np.unique(np.asarray(want[2]))) > 2  # the oracle did resample
    np.testing.assert_allclose(lw.numpy()[same], np.asarray(want[1])[same], rtol=2e-4, atol=2e-4)
    rows = same.all(axis=1)
    np.testing.assert_allclose(xs.numpy()[rows], np.asarray(want[0])[rows], rtol=1e-4, atol=1e-4)


def test_cuda_operands_pack_the_functor_inputs():
    T = 5
    _, (tMt, tGt) = _guided(T, True, np.float64)
    consts, params = tGt.cuda_operands()
    assert tMt.cuda_model == tGt.cuda_model == "spatial_guided"
    mats, vecs, lists, scalars, row_vecs, row_scalars = CF.BLOCK_LANE_MODELS["spatial_guided"]
    W = tGt.ell_width
    assert consts.shape == (mats * B * B + vecs * B + lists * B * W + scalars,)
    assert params.shape == (T - 1, row_vecs * B + row_scalars)
    assert consts[:4].tolist() == [SIG_X, NU, 1.0, W]
    vals = consts[4:4 + B * W].reshape(B, W).numpy()
    cols = consts[4 + B * W:].reshape(B, W).numpy().astype(np.int64)
    assert (np.diff(cols, axis=1)[vals[:, 1:] != 0] > 0).all()  # ascending columns
    dense = np.zeros((B, B))
    np.add.at(dense, (np.repeat(np.arange(B), W), cols.reshape(-1)), vals.reshape(-1))
    np.testing.assert_array_equal(dense, tprec.make_precision_dense(TAU, R_Y, D))
    u, scale, y = tGt.params
    np.testing.assert_array_equal(params[:, :B].numpy(), u.numpy())
    np.testing.assert_array_equal(params[:, B:2 * B].numpy(), y.numpy())
    np.testing.assert_array_equal(params[:, 2 * B].numpy(), scale.numpy())
    # The step's constants: K, lam, scale^2 (nu + B), the log-normalisers,
    # 1 / scale^2, 1 / lam^2.
    sc2 = scale.numpy() ** 2
    K = SIG_X ** 2 / (SIG_X ** 2 + sc2)
    lam2 = SIG_X ** 2 * (1 - K)
    log_c = B * (np.log(2 * np.pi * SIG_X ** 2) + np.log(2 * np.pi * sc2)
                 - np.log(2 * np.pi * lam2))
    np.testing.assert_allclose(params[:, 2 * B + 1:].numpy(), np.stack(
        [K, np.sqrt(lam2), sc2 * (NU + B), log_c, 1 / sc2, 1 / lam2], 1), rtol=1e-12)


def test_unknown_cuda_model_raises_on_the_card(monkeypatch):
    """A tensor on the card with a model the kernel library has no functor
    for raises; nothing falls back (the dispatch is forced to the card's
    branch here: there is no card)."""
    _, (tMt, tGt) = _guided(5, False, np.float64)

    class Unknown(type(tGt)):
        cuda_model = "spatial_unknown"

    gt = Unknown(params=tGt.params, c=tGt.c)
    n = 4
    args = (torch.zeros(n, B, N, dtype=torch.float64),
            torch.full((n, N), 0.5, dtype=torch.float64), torch.zeros(n, B, dtype=torch.float64),
            torch.zeros(B, N, dtype=torch.float64),
            torch.full((N,), 1.0 / N, dtype=torch.float64))
    assert CF.block_lane_scan(tMt, gt, *args)[0].shape == (n, B, N)  # CPU: the plain version
    monkeypatch.setattr(CF, "_on_cuda", lambda name, ref: True)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        CF.block_lane_scan(tMt, gt, *args)
    launched = []
    monkeypatch.setattr(CF, "launch", lambda name, *a: launched.append(name))
    monkeypatch.setattr(CF, "check_cuda_inputs", lambda name, tensors, *a: list(tensors))
    CF.block_lane_scan(tMt, tGt, *args)
    assert launched == ["csmc_block_lane_spatial_guided"]
    CF.block_lane_scan.launches -= 1
    wide = torch.zeros(n, B + 1, N, dtype=torch.float64)
    with pytest.raises(ValueError, match="expected shape"):
        CF.block_lane_scan(tMt, tGt, wide, *args[1:])


# --------------------------------------------------------------------------
# In law
# --------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["kalman-1", "csmc", "csmc-guided"])
def test_init_x_fn_and_short_chain_move(style):
    """`init_x_fn` draws a finite (T, B) trajectory, and a short chain from it
    moves: update rate above 0.05, the bound of the JAX package's own smoke
    tests (`tests/test_models_spatial.py`)."""
    T = 12
    _, ys = _data(T)
    tys = _t(ys)
    gen = torch.Generator().manual_seed(4)
    stencil = _t(tprec.precision_stencil(TAU, R_Y))
    x0 = tsp.init_x_fn(tys, SIG_X, NU, stencil, D, 32, generator=gen)
    assert x0.shape == (T, B) and bool(torch.isfinite(x0).all())
    # The bootstrap filter's trajectory explains the data better than the prior mean does.
    assert float(tsp.log_potential(x0, tys, NU, stencil, D)) > float(
        tsp.log_potential(torch.zeros_like(x0), tys, NU, stencil, D))
    _, (init, kernel), _ = _kernels(style, ys)
    delta = 0.1 if style.startswith("kalman") else torch.full((T,), 0.3, dtype=torch.float64)
    state, updated = init(x0), []
    for _ in range(50):
        state = kernel(state, delta, generator=gen)
        updated.append(state.updated.double().mean())
    assert bool(torch.isfinite(state.x).all())
    assert float(torch.stack(updated).mean()) > 0.05
