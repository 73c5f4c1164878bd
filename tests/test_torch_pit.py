"""The port's parallel-in-time cSMC (`aux_ssm_tpu_torch/kernels/pit.py`) against
the JAX package's, on the CPU.

- `dc_map`: prefix sums and trees with integer leaves.
- `run_stitch_tree`: the recorded selections and the root pair identical to
  JAX's given the noise JAX draws, on the two-pass route (N=25) and the
  blocked route forced at N=128 (JAX: AUX_SSM_STITCH=blocked) with the joint
  draws and with the fused draws (JAX: AUX_SSM_STITCH_DRAWS=fused; route
  "fused" below), odd and even S, with fresh weights joining at later levels.
- Whole `parallel=True` steps of the stochastic-volatility (D=3), spatial
  (3x3) and rare-event models, float64, given JAX's noise: picked indices and
  `updated` identical, trajectories to rtol 1e-9, both routes, gradient off
  and on, T in {1, 2, 37, 64}; the fused draws for SV and rare-event at T in
  {2, 37}; each step runs the stitching kernels' plain versions as the
  dispatch says.
- The invariance of the auxiliary target in law (the JAX package's
  `tests/test_pit.py` check, shorter): fused and generic stitching, with and
  without Qt, blocked with either draws; and the odd-T tail weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import csmc_independent as jind  # noqa: E402
from aux_ssm_tpu.kernels import pit as jpit  # noqa: E402
from aux_ssm_tpu.models import rare_event as jre  # noqa: E402
from aux_ssm_tpu.models import spatial as jsp  # noqa: E402
from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc_independent as tind  # noqa: E402
from aux_ssm_tpu_torch.kernels import pit as tpit  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import Dynamics, Potential, UnivariatePotential  # noqa: E402
from aux_ssm_tpu_torch.models import rare_event as tre  # noqa: E402
from aux_ssm_tpu_torch.models import spatial as tsp  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops import cuda as K  # noqa: E402

f64 = jnp.float64
ROUTES = {"2pass": 25, "blocked": 128, "fused": 128}   # route -> N
# route -> the port's (stitch, draws) and JAX's environment
SETTINGS = {"2pass": ("2pass", "joint"), "blocked": ("blocked", "joint"),
            "fused": ("blocked", "fused")}


def _set_route(monkeypatch, route):
    """JAX's environment for a route; returns the port's (stitch, draws)."""
    stitch, draws = SETTINGS[route]
    monkeypatch.setenv("AUX_SSM_STITCH", stitch)
    monkeypatch.setenv("AUX_SSM_STITCH_DRAWS", draws)
    return stitch, draws


def _t(z):
    return torch.as_tensor(np.array(z))


def jax_tree_noise(resample_keys, T, N):
    """(levels, root) of the stitching tree as JAX's `_pit_csmc` draws them
    from the per-step resample keys: a level's row uniforms from
    fold_in(node_key, 0), its counter seed from randint(first node's key);
    the root's row and column uniforms from fold_in(node_key, 0 / 1). At T=1
    the root holds the one draw's uniform."""
    if T == 1:
        return [], (_t(jax.random.uniform(resample_keys[0], (), f64)).reshape(1), None)
    levels, root = [], None
    sizes = tpit.level_sizes(T)
    for k, n_act in enumerate(sizes):
        keys = resample_keys[np.arange(1 << k, T, 2 << k)]
        assert len(keys) == n_act
        rows = jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(keys)
        if k == len(sizes) - 1:
            u = jax.vmap(lambda kk: jax.random.uniform(kk, (), f64))(rows)
            u2 = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 1), (), f64))(keys)
            root = (_t(u), _t(u2))
        else:
            u_rows = jax.vmap(lambda kk: jax.random.uniform(kk, (N,), f64))(rows)
            seed = jax.random.randint(keys[0], (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
            levels.append((_t(u_rows), _t(seed)))
    return levels, root


def jax_step_noise(key, T, N, d):
    """Every random number of one JAX PIT aux-cSMC step (`csmc_independent.
    _pit_path` then `pit._pit_csmc`), in the port's `noise` layout."""
    key_u, key_inner = jax.random.split(key)
    sample_key, resample_key = jax.random.split(key_inner)
    eps = jnp.stack([jax.random.normal(k, (N, d), f64) for k in jax.random.split(sample_key, T)])
    levels, root = jax_tree_noise(jax.random.split(resample_key, T), T, N)
    return (_t(jax.random.normal(key_u, (T, d), f64)), _t(eps), levels, root)


# --------------------------------------------------------------------------
# dc_map
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 13, 16])
def test_dc_map_prefix_sum(T):
    def op(a, b):
        return torch.cat([a, b + a[:, -1:]], 1)
    out = tpit.dc_map(torch.arange(1.0, T + 1, dtype=torch.float64), op)
    np.testing.assert_allclose(out.numpy(), np.cumsum(np.arange(1.0, T + 1)))
    assert tpit.level_sizes(T) == [len(range(1 << k, T, 2 << k))
                                   for k in range(int(np.log2(tpit._next_pow2(T))))]


def test_dc_map_tree_with_integer_leaves():
    T = 6
    elems = {"v": torch.arange(1.0, T + 1), "i": (torch.arange(T),)}

    def op(a, b):
        return {"v": torch.cat([a["v"], b["v"] + a["v"][:, -1:]], 1),
                "i": (torch.cat([a["i"][0], b["i"][0]], 1),)}
    out = tpit.dc_map(elems, op)
    np.testing.assert_allclose(out["v"].numpy(), np.cumsum(np.arange(1.0, T + 1)))
    np.testing.assert_array_equal(out["i"][0].numpy(), np.arange(T))


# --------------------------------------------------------------------------
# run_stitch_tree
# --------------------------------------------------------------------------

def _sv_absorbed(ys):
    """The PIT path's absorbed transition weight of the SV model, both
    packages, with its right-shifted params."""
    T, d = ys.shape
    jM0, jG0, jMt, jGt = jsv.get_feynman_kac(jnp.asarray(ys), 0.0, 0.9, 2.0, 0.25)
    tM0, tG0, tMt, tGt = tsv.get_feynman_kac(_t(ys), 0.0, 0.9, 2.0, 0.25)
    zeros, ones = np.zeros((T - 1, d)), np.ones(T - 1)
    jgt = jind.AbsorbedGt(trans=jMt, pot=jGt,
                          params=(jMt.params, jGt.params, (zeros, zeros, ones)))
    tgt = tind.AbsorbedGt(trans=tMt, pot=tGt,
                          params=(tMt.params, tGt.params, (_t(zeros), _t(zeros), _t(ones))))
    jparams = jax.tree.map(lambda z: jnp.concatenate([jnp.full_like(z[:1], jnp.nan), z]),
                           jgt.params)
    return jgt, jparams, tgt, tpit._shifted_params(tgt.params)


@pytest.mark.parametrize("route", ["2pass", "blocked", "fused"])
@pytest.mark.parametrize("S", [5, 13])
def test_run_stitch_tree_matches_jax_given_its_noise(monkeypatch, route, S):
    N, d = ROUTES[route], 3
    stitch, draws = _set_route(monkeypatch, route)
    rng = np.random.default_rng(S)
    _, ys = jsv.get_data(jax.random.key(S), 0.0, 0.9, 2.0, 0.25, d, S)
    xs = rng.standard_normal((S, N, d))
    log_wts = rng.standard_normal((S, N))
    log_wts -= np.log(np.exp(log_wts).sum(1, keepdims=True))
    jgt, jparams, tgt, tparams = _sv_absorbed(np.asarray(ys))
    keys = jax.random.split(jax.random.key(S), S)

    @jax.jit
    def jax_tree(xs, log_wts, keys):
        sels, root = jpit.run_stitch_tree(xs, xs, log_wts, keys, jparams, jgt, N,
                                          include_root=True)
        return [(L, R) for L, R, _ in sels], root

    jsels, jroot = jax_tree(jnp.asarray(xs), jnp.asarray(log_wts), keys)
    levels, root = jax_tree_noise(keys, S, N)
    K.reset_launches()
    tsels, troot = tpit.run_stitch_tree(_t(xs), _t(xs), _t(log_wts), levels + [root], tparams,
                                        tgt, N, include_root=True, stitch=stitch, draws=draws)
    assert K.launches()["row_lse"] == 0  # a CPU tensor runs the plain version
    assert len(tsels) == len(jsels)
    for (tl, tr, tn), (jl, jr), n_act in zip(tsels, jsels, tpit.level_sizes(S)):
        assert tn == n_act
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    for tz, jz in zip(troot, jroot):
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    moved = sum(int((tl[:, 1:] != 0).sum()) for tl, _, _ in tsels)
    assert moved > 0
    idx0 = tpit._root_init(troot, S, N)
    np.testing.assert_array_equal(
        tpit.resolve_genealogy(tsels, idx0, S, N).numpy(),
        np.asarray(jpit.resolve_genealogy([(L, R, n) for (L, R), n in zip(jsels, tpit.level_sizes(S))],
                                          jpit._root_init(jroot, S, N), S, N)))


@pytest.mark.parametrize("fused,route", [(False, "2pass"), (True, "2pass"), (True, "blocked"),
                                         (True, "fused")])
@pytest.mark.parametrize("T", [5, 8])
def test_dc_map_stitching_operators_pin_the_reference(fused, route, T):
    """dc_map with the stitching operators (generic, or factorised on either
    route): every merged particle is a proposal of its own step, pair 0 stays
    the reference particle at every level, the log weights become uniform, and
    the root operator returns one trajectory whose origins are its indices."""
    N, d = ROUTES[route], 3
    rng = np.random.default_rng(T)
    _, ys = jsv.get_data(jax.random.key(T), 0.0, 0.9, 2.0, 0.25, d, T)
    _, _, absorbed, params = _sv_absorbed(np.asarray(ys))
    # The generic path takes the same weight as a plain callable.
    tgt = absorbed if fused else (lambda *a: absorbed(*a))
    xs = _t(rng.standard_normal((T, N, d)))
    elems = ((xs, _t(np.log(np.full((T, N), 1.0 / N))), torch.arange(N).expand(T, N)),
             _t(rng.uniform(size=(T, N + 1))), params)

    def op(last):
        if fused:
            return lambda a, b: tpit.fused_stitching_operator(a, b, tgt, N, last,
                                                              *SETTINGS[route])
        return lambda a, b: tpit.stitching_operator(a, b, tgt, N, last)

    (traj, log_w, orig), _, _ = tpit.dc_map(elems, op(False))
    assert traj.shape == (T, N, d) and torch.equal(traj[:, 0], xs[:, 0])
    assert (orig[:, 0] == 0).all() and torch.allclose(log_w, torch.full_like(log_w, -np.log(N)))
    np.testing.assert_array_equal(traj.numpy(), xs.numpy()[np.arange(T)[:, None], orig.numpy()])
    (traj, _, orig), _, _ = tpit.dc_map(elems, op(False), op(True))
    assert traj.shape == (T, d) and orig.shape == (T,)
    np.testing.assert_array_equal(traj.numpy(), xs.numpy()[np.arange(T), orig.numpy()])


# --------------------------------------------------------------------------
# Whole PIT steps of the three models
# --------------------------------------------------------------------------

def _models(model, T, N, gradient, stitch, draws="joint"):
    """(d, x0 (T, d) NumPy, JAX (init, kernel), port (init, kernel)) of one
    model's parallel csmc at T steps."""
    rng = np.random.default_rng(T)
    if model == "sv":
        xs, ys = jsv.get_data(jax.random.key(T), 0.0, 0.9, 2.0, 0.25, 3, T)
        args = (0.0, 0.9, 2.0, 0.25)
        jk = jsv.get_csmc_kernel(ys, *args, N, parallel=True, gradient=gradient)
        fk = tsv.get_feynman_kac(_t(ys), *args)
        return 3, np.asarray(xs), jk, tind.get_kernel(*fk, N, parallel=True, gradient=gradient,
                                                      stitch=stitch, draws=draws)
    if model == "spatial":
        args = (0.3, 4.0, -0.25, 1, 3)
        xs, ys = jsp.get_data(np.random.default_rng(T), 0.3, 1, -0.25, 4.0, 3, T)
        jk = jsp.get_csmc_kernel(ys, *args, N, parallel=True, gradient=gradient)
        fk = tsp.get_feynman_kac(_t(ys), *args)
        x0 = np.asarray(xs) + 0.2 * rng.standard_normal(xs.shape)
        return 9, x0, jk, tind.get_kernel(*fk, N, parallel=True, gradient=gradient, stitch=stitch,
                                          draws=draws)
    y, rho, r2 = 5.0, 0.8, 0.5
    jk = jre.get_csmc_kernel(y, rho, r2, T, N, parallel=True, gradient=gradient)
    fk = tre.get_feynman_kac(y, rho, r2, T, device="cpu")
    x0 = 3.0 + rng.standard_normal((T, 1))
    return 1, x0, jk, tind.get_kernel(*fk, N, parallel=True, gradient=gradient, stitch=stitch,
                                      draws=draws)


@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("model,T,route", [
    (model, T, route) for model in ("sv", "spatial", "rare_event") for T in (1, 2, 37, 64)
    for route in ("2pass", "blocked")] + [
    (model, T, "fused") for model in ("sv", "rare_event") for T in (2, 37)])
def test_pit_step_matches_jax_given_noise(monkeypatch, model, T, route, gradient):
    N = ROUTES[route]
    stitch, draws = _set_route(monkeypatch, route)
    d, x0, (jinit, jkernel), (tinit, tkernel) = _models(model, T, N, gradient, stitch, draws)
    lo, hi = (0.005, 0.05) if model == "spatial" else (0.05, 0.4)
    delta = np.random.default_rng(T + 1).uniform(lo, hi, T)
    jstep = jax.jit(lambda k, s: jkernel(k, s, jnp.asarray(delta)))
    jstate, tstate = jinit(jnp.asarray(x0)), tinit(_t(x0))
    calls = dict.fromkeys(("row_lse", "col_sample", "block_masses", "within_block_cols",
                           "stitch_draws"), 0)
    for name in calls:  # count the wrappers' calls; they run their plain versions here
        fn = getattr(tpit.kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tpit.kernels, name, counted)
    moved = 0
    for key in jax.random.split(jax.random.key(T + 7), 2):
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, _t(delta), noise=jax_step_noise(key, T, N, d))
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9, atol=1e-11)
        moved += int(np.asarray(jstate.updated).sum())
    assert moved > 0
    n_lev = len(tpit.level_sizes(T))
    below = max(n_lev - 1, 0)  # the levels under the root
    blocked = stitch == "blocked"
    want = {"row_lse": 2 * (n_lev if not blocked else min(n_lev, 1)),
            "col_sample": 2 * (below if not blocked else 0),
            "block_masses": 2 * (below if blocked else 0),
            "within_block_cols": 2 * (below if route == "blocked" else 0),
            "stitch_draws": 2 * (below if route == "fused" else 0)}
    assert calls == want


def test_pit_noise_drawn_from_a_generator_has_the_tree_layout():
    T, N = 13, 16
    x = torch.zeros(T, 2, dtype=torch.float64)
    levels, root = tpit.draw_noise(T, N, x, torch.Generator().manual_seed(0))
    assert [u.shape for u, _ in levels] == [(n, N) for n in tpit.level_sizes(T)[:-1]]
    assert all(s.dtype == torch.int32 and s.dim() == 0 and 0 <= int(s) for _, s in levels)
    assert root[0].shape == root[1].shape == (1,)
    with pytest.raises(ValueError, match="stitch"):
        tpit.get_kernel(None, None, None, N, stitch="fused")
    for draws in ("unfused", "blocked", ""):  # JAX's `unfused` mode is not ported
        with pytest.raises(ValueError, match="draws"):
            tpit.get_kernel(None, None, None, N, draws=draws)
        with pytest.raises(ValueError, match="draws"):
            tind.get_kernel(None, None, None, None, N, parallel=True, draws=draws)


# --------------------------------------------------------------------------
# The invariant law
# --------------------------------------------------------------------------

T_INV, PHI, SIG_X, SIG_Y = 6, 0.9, 0.5, 0.4


class _ARDynamics(Dynamics):
    """x_{t+1} ~ N(phi x_t, sig^2), d = 1."""
    def logpdf(self, x_next, x_t, params):
        z = (x_next - PHI * x_t) / SIG_X
        return (-0.5 * z * z - np.log(SIG_X) - 0.5 * np.log(2 * np.pi)).sum(-1)

    def logpdf_factors(self, x_prev, x_next, params):
        from aux_ssm_tpu_torch.kernels.csmc_base import diag_gaussian_pair_factors
        return diag_gaussian_pair_factors(PHI * x_prev, x_next, SIG_X)


class _Prior(UnivariatePotential):
    def logpdf(self, x):
        return (-0.5 * x * x - 0.5 * np.log(2 * np.pi)).sum(-1)


def _obs(ys, prev_dependent):
    class ObsGt(Potential):
        def __call__(self, x_next, x_t, y):
            y = y.unsqueeze(-2) if x_next.dim() > y.dim() else y
            z = (x_next - y) / SIG_Y
            return (-0.5 * z * z - np.log(SIG_Y) - 0.5 * np.log(2 * np.pi)).sum(-1)
    ObsGt.prev_dependent = prev_dependent

    class ObsG0(UnivariatePotential):
        def __call__(self, x):
            return ObsGt()(x, x, ys[0])
    return ObsG0(), ObsGt(params=ys[1:])


def _smoother(ys):
    """Exact smoothing means and sds of the AR(1) + Gaussian-observation model."""
    T = len(ys)
    cov = np.empty((T, T))
    for s in range(T):
        for t in range(T):
            a, b = min(s, t), max(s, t)
            v = sum(PHI ** (2 * (a - i)) * (1.0 if i == 0 else SIG_X ** 2) for i in range(a + 1))
            cov[s, t] = PHI ** (b - a) * v
    gain = cov @ np.linalg.inv(cov + SIG_Y ** 2 * np.eye(T))
    return gain @ ys, np.sqrt(np.diag(cov - gain @ cov))


@pytest.mark.parametrize("with_qt,fused,route", [(False, False, "2pass"), (True, False, "2pass"),
                                                 (False, True, "2pass"), (True, True, "2pass"),
                                                 (False, True, "blocked"), (False, True, "fused")])
def test_pit_csmc_invariance_in_law(with_qt, fused, route):
    """The auxiliary Gibbs chain (u refresh + PIT kernel) keeps the LGSSM
    smoothing posterior: chain means within 6 Monte-Carlo standard errors
    (30 iterations per independent sample, as the JAX package's test takes)
    and standard deviations within 20%."""
    N = 32 if route == "2pass" else ROUTES[route]
    ys = np.random.default_rng(0).standard_normal((T_INV, 1)) * 0.5
    G0, Gt = _obs(_t(ys), prev_dependent=not fused)
    M0, Mt = _Prior(), _ARDynamics(params=torch.zeros(T_INV - 1, 0, dtype=torch.float64))
    assert getattr(tind.AbsorbedGt(trans=Mt, pot=Gt), "supports_pairwise_factors") == fused
    stitch, draws = SETTINGS[route]
    init, kernel = tind.get_kernel(M0, G0, Mt, Gt, N, gradient=with_qt, parallel=True,
                                   stitch=stitch, draws=draws)
    gen = torch.Generator().manual_seed(1)
    state = init(torch.zeros(T_INV, 1, dtype=torch.float64))
    n_iter, out, upd = 3000, [], []
    for _ in range(n_iter):
        state = kernel(state, 0.8, generator=gen)
        out.append(state.x[:, 0].clone())
        upd.append(state.updated.double().mean())
    xs = torch.stack(out).numpy()[n_iter // 4:]
    assert float(torch.stack(upd).mean()) > 0.2
    mean, sd = _smoother(ys[:, 0])
    np.testing.assert_allclose(xs.mean(0), mean, atol=6 * sd.max() / np.sqrt(len(xs) / 30))
    np.testing.assert_allclose(xs.std(0), sd, rtol=0.2)


@pytest.mark.parametrize("T_odd", [3, 5])
def test_pit_odd_T_tail_importance_weights(T_odd):
    """With flat potentials and Qt given, the invariant law is Qt's marginals:
    the chain mean at every step, t = T-1 included, moves to Qt's location."""
    loc = np.zeros((T_odd, 1))
    loc[0, 0], loc[-1, 0] = 2.0, 3.0
    ones = torch.ones(T_odd, dtype=torch.float64)
    Mt = tind.DiagonalGaussian(loc=torch.zeros(T_odd, 1, dtype=torch.float64), scale=ones)
    Qt = tind.DiagonalGaussian(loc=_t(loc), scale=ones)

    class Flat0(UnivariatePotential):
        def __call__(self, x):
            return x.new_zeros(x.shape[:-1])

    class Flat(Potential):
        def __call__(self, x_next, x_t, _):
            return (x_next + x_t).new_zeros(torch.broadcast_shapes(x_next.shape,
                                                                   x_t.shape)[:-1])

    init, kernel = tpit.get_kernel(Mt, Flat0(), Flat(params=torch.zeros(T_odd - 1, 1)), 64,
                                   Qt=Qt)
    gen = torch.Generator().manual_seed(2)
    state, out = init(torch.zeros(T_odd, 1, dtype=torch.float64)), []
    for _ in range(1500):
        state = kernel(state, generator=gen)
        out.append(state.x[:, 0].clone())
    xs = torch.stack(out).numpy()[300:]
    np.testing.assert_allclose(xs.mean(0), loc[:, 0], atol=6 / np.sqrt(len(xs) / 10))
