"""The plain version of the lane cSMC sweep
(`aux_ssm_tpu_torch/ops/cuda/csmc_fwd.lane_scan_plain`) and the port's lane
forward pass against the JAX package.

- float64 against the XLA oracle `lane_scan_xla`, with the theta-logistic and
  the rare-event guided lane callables, PGAS on and off: ancestors identical,
  particles and log weights to rtol 1e-12 (the same algebra step for step).
  The oracle rounds the per-step params to float32 whatever their dtype, so
  both sides are given params that float32 holds exactly (and scales whose
  squares it holds exactly: the guided mean squares the float32 scale).
- float32 against the Pallas kernel run with `interpret=True`: the two sides
  take prefix sums in other orders, so an ancestor may flip where a uniform
  falls within rounding of a CDF step, and here a flip changes the state too.
  Each step of the port starts from the Pallas kernel's previous step (its
  particles and weights); >= 99.5% of ancestors must agree, values to 2e-4
  where they do (the JAX package's own bound between its kernel and oracle).
- The port's lane forward pass against its own generic loop, given the same
  noise: same ancestors, values to rtol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.models import rare_event as jre  # noqa: E402
from aux_ssm_tpu.models import theta_logistic as jtl  # noqa: E402
from aux_ssm_tpu.ops.pallas import csmc_fwd as jcf  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc as tcsmc  # noqa: E402
from aux_ssm_tpu_torch.kernels.csmc_base import tree_map  # noqa: E402
from aux_ssm_tpu_torch.models import ar1_gauss  # noqa: E402
from aux_ssm_tpu_torch.models import rare_event as tre  # noqa: E402
from aux_ssm_tpu_torch.models import theta_logistic as ttl  # noqa: E402
from aux_ssm_tpu_torch.ops import resampling as tres  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402

Y, RHO, R2 = 5.0, 0.8, 0.5


def _f32_exact(z):
    """`z` rounded to values float32 holds exactly, as float64."""
    return np.asarray(z, np.float32).astype(np.float64)


def _t(z, dtype=None):
    return torch.as_tensor(np.array(z), dtype=dtype)


def _models(model, T, seed, monkeypatch, np_dtype=np.float64):
    """(JAX Mt, Gt), (port Mt, Gt) of `model` at T steps, both with per-step
    params that float32 holds exactly, cast to `np_dtype`."""
    rng = np.random.default_rng(seed)
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    if model == "theta":
        ys = _f32_exact(1.0 + 0.3 * rng.standard_normal((T, 1))).astype(np_dtype)
        _, _, jMt, jGt = jtl.get_feynman_kac(jnp.asarray(ys))
        _, _, tMt, tGt = ttl.get_feynman_kac(_t(ys))
        return (jMt, jGt), (tMt, tGt)
    # The guided rare-event factories, taken from where the kernel functions
    # hand them to csmc_aux.
    monkeypatch.setattr(jre.csmc_aux, "get_kernel", lambda factory, *a, **k: factory)
    monkeypatch.setattr(tre.csmc_aux, "get_kernel", lambda factory, *a, **k: factory)
    gradient = model == "guided-grad"
    jfac = jre.get_guided_csmc_kernel(Y, RHO, R2, T, 8, gradient=gradient)
    tfac = tre.get_guided_csmc_kernel(Y, RHO, R2, T, 8, gradient=gradient, dtype=tdt,
                                      device="cpu")
    u = rng.standard_normal((T, 1)).astype(np_dtype)
    scale = (rng.integers(20, 60, T) / 64.0).astype(np_dtype)  # 6 bits: squares stay exact
    _, _, jMt, jGt = jfac(jnp.asarray(u), jnp.asarray(scale))
    _, _, tMt, tGt = tfac(_t(u), _t(scale))
    rounded = {k: _f32_exact(v).astype(np_dtype) for k, v in jMt.params.items()}
    for k, v in tMt.params.items():  # the port builds the same params
        np.testing.assert_allclose(v.numpy(), np.asarray(jMt.params[k]), rtol=1e-6)
    jp = {k: jnp.asarray(v) for k, v in rounded.items()}
    tp = {k: _t(v) for k, v in rounded.items()}
    rep = lambda obj, p: type(obj)(**{**obj.__dict__, "params": p})  # noqa: E731
    return (jMt.replace(params=jp), jGt.replace(params=jp)), (rep(tMt, tp), rep(tGt, tp))


def _sweep_inputs(T, N, seed, np_dtype=np.float64):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.1, 1.0, N)
    return tuple(z.astype(np_dtype) for z in (
        rng.standard_normal((T - 1, N)), rng.uniform(size=(T - 1, N)), rng.uniform(size=T - 1),
        1.0 + 0.5 * rng.standard_normal(T - 1), 1.0 + 0.5 * rng.standard_normal(N),
        w0 / w0.sum()))


def _call_both(jm, tm, pgas, inputs):
    (jMt, jGt), (tMt, tGt) = jm, tm
    want = jcf.lane_scan_xla(jMt.lane_propagate, jGt.lane_logw,
                             jMt.lane_logpdf if pgas else None, jMt.params, jGt.params,
                             jMt.params if pgas else None, *(jnp.asarray(z) for z in inputs))
    got = CF.lane_scan(tMt, tGt, tMt if pgas else None, *(_t(z) for z in inputs))
    return got, want


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("N", [8, 128])
@pytest.mark.parametrize("model", ["theta", "guided", "guided-grad"])
def test_lane_scan_matches_xla_oracle_f64(monkeypatch, model, N, pgas):
    T = 14
    jm, tm = _models(model, T, seed=N, monkeypatch=monkeypatch)
    (xs, lw, anc), (xs_x, lw_x, anc_x) = _call_both(jm, tm, pgas, _sweep_inputs(T, N, seed=3))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_x))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_x), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(lw.numpy(), np.asarray(lw_x), rtol=1e-12, atol=1e-13)


def _carry(lw):
    w = torch.exp(lw - lw.max())
    return w / w.sum()


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("model,T,N", [("theta", 20, 24), ("guided-grad", 12, 128),
                                       ("theta", 6, 2048)])
def test_lane_scan_matches_pallas_interpret_f32(monkeypatch, model, T, N, pgas):
    (jMt, jGt), (tMt, tGt) = _models(model, T, seed=2, monkeypatch=monkeypatch,
                                     np_dtype=np.float32)
    inputs = _sweep_inputs(T, N, seed=5, np_dtype=np.float32)
    xs_p, lw_p, anc_p = jcf.lane_forward_scan(
        jMt.lane_propagate, jGt.lane_logw, jMt.lane_logpdf if pgas else None, jMt.params,
        jGt.params, jMt.params if pgas else None, *(jnp.asarray(z) for z in inputs),
        interpret=True)
    eps, res_u, anc_u, x_star, x0, w0 = (_t(z) for z in inputs)
    xs_ref, lw_ref = _t(xs_p), _t(lw_p)
    steps = []
    for t in range(T - 1):  # each step from the Pallas kernel's particles and weights
        sl = slice(t, t + 1)
        at = lambda p: tree_map(lambda z: z[sl], p)  # noqa: E731
        steps.append(CF.lane_scan_plain(
            tMt.lane_propagate, tGt.lane_logw, tMt.lane_logpdf if pgas else None,
            at(tMt.params), at(tGt.params), at(tMt.params) if pgas else None, eps[sl],
            res_u[sl], anc_u[sl], x_star[sl], x0 if t == 0 else xs_ref[t - 1],
            w0 if t == 0 else _carry(lw_ref[t - 1])))
    xs, lw, anc = (torch.cat(z) for z in zip(*steps))
    assert xs.dtype == torch.float32
    agree = anc.numpy() == np.asarray(anc_p)
    assert agree.mean() >= 0.995, agree.mean()
    for got, want in ((xs, xs_p), (lw, lw_p)):
        np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree],
                                   rtol=2e-4, atol=2e-4)


def _forward_models(model, T):
    if model == "theta":
        ys = _t(1.0 + 0.3 * np.random.default_rng(0).standard_normal((T, 1)))
        return ttl.get_feynman_kac(ys)
    if model == "ar1":
        return ar1_gauss.get_feynman_kac(
            _t(np.random.default_rng(0).standard_normal((T - 1, 1))))
    return tre.get_feynman_kac(Y, RHO, R2, T, device="cpu")


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("model", ["theta", "ar1", "rare-bootstrap"])
def test_lane_forward_pass_matches_generic_loop(monkeypatch, model, pgas):
    T, N = 10, 16
    M0, G0, Mt, Gt = _forward_models(model, T)
    rng = np.random.default_rng(7)
    noise = tuple(_t(z) for z in (rng.standard_normal((N, 1)), rng.uniform(size=(T - 1, N)),
                                  rng.standard_normal((T - 1, N, 1)), rng.uniform(size=T - 1)))
    x_star = _t(np.linspace(0.5, 1.5, T))[:, None]
    args = (x_star, M0, G0, Mt, Gt, N, tres.multinomial, noise)
    assert tcsmc._use_lane_forward(x_star, Mt, Gt, tres.multinomial, Mt if pgas else None, N)
    lane = tcsmc.forward_pass(*args, ancestor_Pt=Mt if pgas else None)
    monkeypatch.setattr(tcsmc, "_use_lane_forward", lambda *a: False)
    generic = tcsmc.forward_pass(*args, ancestor_Pt=Mt if pgas else None)
    np.testing.assert_array_equal(lane[3].numpy(), generic[3].numpy())
    for got, want in zip(lane[:3], generic[:3]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-13)


def test_lane_dispatch_by_capability():
    """Scalar state, multinomial resampling, N <= 8192 and a multiple of 128
    past 1024, lane callables on Mt and Gt, `lane_logpdf` on the ancestor
    dynamics under PGAS."""
    M0, G0, Mt, Gt = _forward_models("theta", 6)
    x = torch.zeros(6, 1, dtype=torch.float64)
    use = tcsmc._use_lane_forward
    assert use(x, Mt, Gt, tres.multinomial, None, 256)
    assert use(x, Mt, Gt, tres.multinomial, Mt, 4096)
    assert not use(x, Mt, Gt, tres.systematic, None, 256)
    assert not use(x, Mt, Gt, tres.multinomial, None, 1100)
    assert not use(x, Mt, Gt, tres.multinomial, None, 16384)
    assert not use(torch.zeros(6, 2), Mt, Gt, tres.multinomial, None, 256)
    assert not use(x, Mt, Gt, tres.multinomial, object(), 256)
    assert not use(x, object(), Gt, tres.multinomial, None, 256)


def test_lane_scan_without_cuda_functor_raises_on_the_card(monkeypatch):
    """A model with lane callables and no CUDA functor, or with another
    ancestor transition than its own, runs the plain version for CPU tensors;
    for CUDA tensors the wrapper raises instead of falling back (the dispatch
    is forced to the card's branch here)."""
    _, _, Mt, Gt = _forward_models("theta", 6)

    class NoFunctor(type(Gt)):
        cuda_model = None

    gt = NoFunctor(**Gt.__dict__)
    _, _, other, _ = _forward_models("theta", 6)
    inputs = tuple(_t(z) for z in _sweep_inputs(6, 4, seed=1))
    assert CF.lane_scan(Mt, gt, None, *inputs)[0].shape == (5, 4)
    assert CF.lane_scan(Mt, Gt, other, *inputs)[0].shape == (5, 4)
    monkeypatch.setattr(CF, "_on_cuda", lambda name, ref: True)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        CF.lane_scan(Mt, gt, None, *inputs)
    with pytest.raises(NotImplementedError, match="own transition"):
        CF.lane_scan(Mt, Gt, other, *inputs)
