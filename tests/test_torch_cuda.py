"""The CUDA kernels of `aux_ssm_tpu_torch` on the card against their plain
PyTorch versions on the CPU, given the same inputs. Skipped without a CUDA
card. On a machine with a card and without JAX run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: in float64 kernel and plain compute the same algebra with other
summation orders and solvers, so they agree to ~1e-12 (rtol 1e-9 checks
every term), and the cSMC sweeps' indices are identical. The float32 bounds
at the main path's shapes are in `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu_torch import get_kernel  # noqa: E402
from aux_ssm_tpu_torch.models import lgssm_flagship  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as sv  # noqa: E402
from aux_ssm_tpu_torch.ops import cuda as K  # noqa: E402
from aux_ssm_tpu_torch.ops.filtering import (  # noqa: E402
    _make_associative_elements, filtering, kalman_update)
from aux_ssm_tpu_torch.ops.lgssm import LGSSM  # noqa: E402

pytestmark = pytest.mark.cuda

KF, FS, CF = K.kalman_fused, K.filter_scan, K.csmc_fwd


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(T, dx, dy, seed, nan_frac=0.0):
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = list(random_lgssm(rng, T, dx, dy))
    params[2] = params[2] * min(1.0, 2.0 / np.sqrt(dx))  # keep F stable at large dx
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    return LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys)


def _to(a, dev):
    if isinstance(a, tuple):
        return tuple(_to(z, dev) for z in a)
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _both(fn, args, dev):
    """fn on the CPU (plain) and on the card (kernel); outputs as tuples."""
    want = fn(*args)
    before = fn.launches
    got = fn(*(_to(a, dev) for a in args))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    as_tuple = (lambda z: z if isinstance(z, tuple) else (z,))
    return as_tuple(want), tuple(g.cpu() for g in as_tuple(got))


def _close(got, want, rtol=1e-9, atol=1e-11):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(64, 4, 3, 0.3), (300, 3, 1, 0.0),
                                              (40, 16, 16, 0.1)])
def test_maps_match_plain(dev, T, dx, dy, nan_frac):
    lg, ys = _model(T, dx, dy, seed=T, nan_frac=nan_frac)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    obs = (Hs[1:], Rs[1:], cs[1:], ys[1:])
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    n = T - 1
    m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
    _close(*_both(KF.make_elements, (Fs, Qs, bs, *obs, m, P), dev))

    ms, Ps, _ = filtering(ys, lg, parallel=True)
    _close(*_both(KF.ell, (Fs, Qs, bs, *obs, ms[:-1], Ps[:-1]), dev))

    eps = torch.as_tensor(np.random.default_rng(1).standard_normal((n, dx)))
    # The jittered Cholesky of a near-singular covariance amplifies rounding.
    _close(*_both(KF.backward_maps, (Fs, Qs, bs, ms[:-1], Ps[:-1], eps), dev),
           rtol=1e-7, atol=1e-9)

    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((T, dx)))
    _close(*_both(KF.logdensity_steps, (Fs, Qs, bs, *obs, xs[:-1], xs[1:]), dev))


@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (300, 3, 2), (1025, 4, 3)])
def test_filter_scan_matches_plain(dev, T, dx, dy):
    lg, ys = _model(T, dx, dy, seed=3)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0u, P0u)
    _close(*_both(FS.filter_scan, (elems,), dev))


@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (1024, 16, True), (100, 4, False)])
def test_affine_scan_matches_plain(dev, T, d, reverse):
    rng = np.random.default_rng(1)
    gains = torch.as_tensor(0.4 / np.sqrt(d) * rng.standard_normal((T, d, d)))
    incs = torch.as_tensor(rng.standard_normal((T, d)))
    _close(*_both(FS.affine_scan, (gains, incs, reverse), dev))


def test_rejects_what_the_kernels_do_not_take(dev):
    b = torch.zeros(8, 17, device=dev)
    with pytest.raises(ValueError, match="dimensions"):
        FS.affine_scan(torch.zeros(8, 17, 17, device=dev), b)
    with pytest.raises(TypeError):
        FS.affine_scan(torch.zeros(8, 2, 2, device=dev), torch.zeros(8, 2, device=dev,
                                                                     dtype=torch.float16))


@pytest.mark.parametrize("order", [1, 2])
def test_step_matches_cpu(dev, order):
    """Three MH steps of the flagship (T=64, dx=8) on the card, float64,
    against the CPU given the same noise."""
    T, dx = 64, 8
    out = {}
    for where in ("cpu", dev):
        dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(
            T, dx, device=where, dtype=torch.float64)
        init, kernel = get_kernel(dyn, obs1 if order == 1 else obs2, tf, parallel=True)
        rng = np.random.default_rng(order)
        state = init(torch.zeros(T, dx, dtype=torch.float64, device=where))
        xs = []
        for _ in range(3):
            noise = (torch.as_tensor(rng.standard_normal((T, dx)), device=where),
                     torch.as_tensor(rng.standard_normal((T, dx)), device=where),
                     torch.as_tensor(rng.uniform(), dtype=torch.float64, device=where))
            state = kernel(state, 0.1, noise=noise)
            xs.append((state.x.cpu(), bool(state.updated), float(state.log_target)))
        out[str(where)] = xs
    for (xc, uc, lc), (xg, ug, lg) in zip(out["cpu"], out[str(dev)]):
        assert uc == ug
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(lg, lc, rtol=1e-9)


# --------------------------------------------------------------------------
# The cSMC sweeps and the stochastic-volatility particle-Gibbs step
# --------------------------------------------------------------------------

SV_PARAMS = (0.0, 0.9, 2.0, 0.25)


def _factor_inputs(n, N, k, seed):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.1, 1.0, N)
    return tuple(torch.as_tensor(z) for z in (
        0.5 * rng.standard_normal((n, N, k)), 0.5 * rng.standard_normal((n, N, k)),
        rng.standard_normal((n, N)), rng.standard_normal((n, N)), rng.uniform(size=(n, N)),
        rng.uniform(size=n), w0 / w0.sum()))


@pytest.mark.parametrize("n,N,k,pgas", [(23, 32, 2, False), (23, 32, 2, True),
                                        (9, 300, 30, False), (5, 4096, 1, True)])
def test_forward_factor_matches_plain(dev, n, N, k, pgas):
    _close(*_both(CF.forward_factor_scan, _factor_inputs(n, N, k, seed=N) + (pgas,), dev))


@pytest.mark.parametrize("n,N,k", [(19, 16, 3), (24, 25, 30), (6, 4096, 1)])
def test_backward_factor_matches_plain(dev, n, N, k):
    rf, cf, rb, lw, _, us, _ = _factor_inputs(n, N, k, seed=k)
    _close(*_both(CF.backward_factor_scan, (rf, cf, rb, lw, us, torch.tensor(3)), dev))


@pytest.mark.parametrize("T,D,N", [(12, 3, 16), (40, 30, 25), (9, 30, 1024)])
def test_block_lane_matches_plain(dev, T, D, N):
    _, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(T))
    rng = np.random.default_rng(D)
    n = T - 1
    inputs = tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((T, D)), rng.uniform(0.3, 0.6, size=T),
        rng.standard_normal((n, D, N)), rng.uniform(size=(n, N)),
        rng.standard_normal((n, D)), rng.standard_normal((D, N)), np.full(N, 1.0 / N)))
    out = []
    for where in ("cpu", dev):
        u, scale, *sweep = (z.to(where) for z in inputs)
        factory, _ = sv.make_guided_factory(ys.to(where), *SV_PARAMS)
        _, _, Mt, Gt = factory(u, scale)
        before = CF.block_lane_scan.launches
        out.append(tuple(z.cpu() for z in CF.block_lane_scan(Mt, Gt, *sweep)))
    assert CF.block_lane_scan.launches == before + 1
    _close(out[1], out[0])


@pytest.mark.parametrize("style", ["csmc", "csmc-guided"])
@pytest.mark.parametrize("gradient", [False, True])
def test_csmc_step_matches_cpu(dev, style, gradient):
    """Two f64 aux-cSMC steps of the SV model (T=32, D=4, N=16, backward
    sampling) on the card against the CPU, given the same noise."""
    T, D, N = 32, 4, 16
    xs, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    delta = torch.as_tensor(rng.uniform(0.2, 1.0, T))
    noises = [tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((T, D)), rng.standard_normal((N, D)), rng.uniform(size=(T - 1, N)),
        rng.standard_normal((T - 1, N, D)), rng.uniform(size=T - 1), rng.uniform(size=T)))
        for _ in range(2)]
    get = sv.get_csmc_kernel if style == "csmc" else sv.get_guided_csmc_kernel
    out = []
    for where in ("cpu", dev):
        init, kernel = get(ys.to(where), *SV_PARAMS, N, backward=True, gradient=gradient)
        state = init(xs.to(where))
        before = CF.backward_factor_scan.launches
        steps = []
        for noise in noises:
            state = kernel(state, delta.to(where), noise=_to(noise, where))
            steps.append((state.x.cpu(), state.updated.cpu()))
        out.append(steps)
    assert CF.backward_factor_scan.launches == before + len(noises)
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)
