"""The CUDA kernels of `aux_ssm_tpu_torch` on the card against their plain
PyTorch versions on the CPU, given the same inputs. Skipped without a CUDA
card. On a machine with a card and without JAX run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: in float64 kernel and plain compute the same algebra with other
summation orders and solvers, so they agree to ~1e-12 (rtol 1e-9 checks
every term), and the cSMC sweeps' indices are identical. The float32 bounds
at the main path's shapes are in `chip_smoke.py`.
"""
import dataclasses

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


def _model(T, dx, dy, seed, nan_frac=0.0, nan_model=False):
    """A random LGSSM and its observations, a share `nan_frac` of them
    missing (NaN); with `nan_model`, also H, R and c NaN on the missing rows
    and step 1 missing whole."""
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = list(random_lgssm(rng, T, dx, dy))
    params[2] = params[2] * min(1.0, 2.0 / np.sqrt(dx))  # keep F stable at large dx
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    if nan_model:
        ys[1] = np.nan
        miss = np.isnan(ys)
        H, R, c = (np.array(z) for z in params[5:8])
        H[miss] = np.nan
        R[miss] = np.nan
        R.transpose(0, 2, 1)[miss] = np.nan
        c[miss] = np.nan
        params[5:8] = H, R, c
    return LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys)


def _to(a, dev):
    if isinstance(a, tuple):
        return tuple(_to(z, dev) for z in a)
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _both(fn, args, dev, launches=1):
    """fn on the CPU (plain) and on the card (kernel, `launches` launches);
    outputs as tuples."""
    want = fn(*args)
    before = fn.launches
    got = fn(*(_to(a, dev) for a in args))
    torch.cuda.synchronize()
    assert fn.launches == before + launches
    as_tuple = (lambda z: z if isinstance(z, tuple) else (z,))
    return as_tuple(want), tuple(g.cpu() for g in as_tuple(got))


def _close(got, want, rtol=1e-9, atol=1e-11):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol)


def _element_inputs(T, dx, dy, nan_frac, nan_model=False):
    lg, ys = _model(T, dx, dy, seed=T, nan_frac=nan_frac, nan_model=nan_model)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    n = T - 1
    m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
    return lg, ys, (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m, P)


# The elements, ell and logdensity kernels pad dx, dy to the instance's D:
# d = 16 (the main path's T too), dx = 16 over padded observation rows, d =
# 1, dy < dx and dy > dx, n = 1 and 2, and every masking branch; the D = 32
# instance at the SV model's d = 30 and T = 250, the edges d = 17 and 32,
# and dx != dy either way.
@pytest.mark.parametrize("T,dx,dy,nan_frac,nan_model", [
    (64, 4, 3, 0.3, False), (300, 3, 1, 0.0, False), (40, 16, 16, 0.1, False),
    (1024, 16, 16, 0.1, True), (30, 1, 1, 0.3, False), (2, 3, 2, 0.0, False),
    (3, 5, 2, 0.5, True), (20, 2, 5, 0.4, True), (24, 16, 5, 0.3, True),
    (250, 30, 30, 0.2, True), (20, 17, 17, 0.0, False), (20, 32, 32, 0.3, True),
    (20, 30, 17, 0.2, False), (12, 5, 30, 0.3, True)])
def test_maps_match_plain(dev, T, dx, dy, nan_frac, nan_model):
    lg, ys, args = _element_inputs(T, dx, dy, nan_frac, nan_model)
    Fs, Qs, bs, *obs = args[:7]
    n = T - 1
    _close(*_both(KF.make_elements, args, dev))

    ms, Ps, _ = filtering(ys, lg, parallel=True)
    _close(*_both(KF.ell, (Fs, Qs, bs, *obs, ms[:-1], Ps[:-1]), dev))

    eps = torch.as_tensor(np.random.default_rng(1).standard_normal((n, dx)))
    # The jittered Cholesky of a near-singular covariance amplifies rounding.
    _close(*_both(KF.backward_maps, (Fs, Qs, bs, ms[:-1], Ps[:-1], eps), dev),
           rtol=1e-7, atol=1e-9)

    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((T, dx)))
    _close(*_both(KF.logdensity_steps, (Fs, Qs, bs, *obs, xs[:-1], xs[1:]), dev))


# The Lorenz proposal's shape (dx = 3, u rows stacked on two data rows, dy =
# 5) with a huge variance on the u rows: at delta = 1e20 (R = 5e19, float32)
# and 1e160 (float64) the product of two diagonal entries of S overflows,
# which a 2 x 2 pivot block's determinant took before it was scaled
# (make_elements gave NaN on the card). The data rows are missing on every
# step but the first, as on most Mider steps. float32 against the plain
# version on the CPU at the norm-relative 1e-4 of chip_smoke.NREL_F32.
@pytest.mark.parametrize("dtype,big", [(torch.float32, 5e19), (torch.float64, 1e160)])
def test_maps_huge_observation_variance(dev, dtype, big):
    lg, ys, _ = _element_inputs(40, 3, 5, 0.0)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = (z.clone() for z in lg)
    eye = torch.eye(3, dtype=torch.float64)
    Hs[:, :3], Rs[:, :3], Rs[:, :, :3], cs[:, :3] = eye, 0.0, 0.0, 0.0
    Rs[:, :3, :3] = big * eye
    ys = ys.clone()
    ys[:, :3] = big ** 0.5 * ys[:, :3]
    ys[1:, 3:] = float("nan")
    lg = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    n = ys.shape[0] - 1
    m = torch.cat([m0u[None], torch.zeros(n - 1, 3, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, 3, 3, dtype=torch.float64)])
    ms, Ps, _ = filtering(ys, lg, parallel=True)
    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((n + 1, 3)))
    obs = (Hs[1:], Rs[1:], cs[1:], ys[1:])
    for fn, args in ((KF.make_elements, (Fs, Qs, bs, *obs, m, P)),
                     (KF.ell, (Fs, Qs, bs, *obs, ms[:-1], Ps[:-1])),
                     (KF.logdensity_steps, (Fs, Qs, bs, *obs, xs[:-1], xs[1:]))):
        want, got = _both(fn, tuple(a.to(dtype).contiguous() for a in args), dev)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all()), fn.__name__
            err = float((g.double() - w.double()).norm() / w.double().norm())
            assert err <= (1e-4 if dtype == torch.float32 else 1e-9), (fn.__name__, err)


def _column_cholesky(M):
    """The lower Cholesky factor of M column by column, entries times 1 /
    diag, as the JAX kernel's lanelin.chol; NaN and inf from a pivot that is
    not positive on, then 0 (safe_cholesky's nan_to_num)."""
    d = M.shape[0]
    L = np.zeros_like(M)
    with np.errstate(invalid="ignore", divide="ignore"):
        for j in range(d):
            L[j, j] = np.sqrt(M[j, j] - L[j, :j] @ L[j, :j])
            L[j + 1:, j] = (M[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) * (1.0 / L[j, j])
    return np.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)


@pytest.mark.parametrize("case", ["zero_cov", "not_pd"])
def test_backward_maps_degenerate_covariance(dev, case):
    """backward_maps where the conditional covariance is exactly 0 (step 3: P
    = 0; the plain version's factor is 0 as well) or not positive definite (F
    = 0.9 I, Q = I, P = diag(1, 0.5, -0.3)): there the kernel keeps the
    columns before the failing pivot, as JAX's Pallas kernel does
    (`_column_cholesky`), where the plain version zeroes the whole factor."""
    rng = np.random.default_rng(11)
    n, dx = 8, 3
    b, m, eps = (rng.standard_normal((n, dx)) for _ in range(3))
    if case == "zero_cov":
        A, B = rng.standard_normal((2, n, dx, dx))
        P = A @ A.transpose(0, 2, 1) / dx + 0.1 * np.eye(dx)
        P[3] = 0.0
        F = 0.5 * rng.standard_normal((n, dx, dx))
        Q = B @ B.transpose(0, 2, 1) / dx + 0.5 * np.eye(dx)
    else:
        F = np.broadcast_to(0.9 * np.eye(dx), (n, dx, dx))
        Q = np.broadcast_to(np.eye(dx), (n, dx, dx))
        P = np.broadcast_to(np.diag([1.0, 0.5, -0.3]), (n, dx, dx))
    args = tuple(torch.as_tensor(np.ascontiguousarray(z)) for z in (F, Q, b, m, P, eps))
    want, got = _both(KF.backward_maps, args, dev)
    if case == "zero_cov":
        _close(got, want, rtol=1e-7, atol=1e-9)
        assert not bool(got[0][3].any()) and torch.equal(got[1][3], args[3][3])
        return
    S = F @ P @ F.transpose(0, 2, 1) + Q
    G = np.linalg.solve(S, F @ P).transpose(0, 2, 1)
    cov = P - G @ S @ G.transpose(0, 2, 1)
    jitter = (32 * np.finfo(float).eps / dx) * np.trace(cov, axis1=1, axis2=2)
    cov = cov + jitter[:, None, None] * np.eye(dx)
    L = np.stack([_column_cholesky(c) for c in cov])
    mv = lambda A, x: np.einsum("tij,tj->ti", A, x)  # noqa: E731
    inc = m - mv(G, mv(F, m) + b) + mv(L, eps)
    _close(got, (torch.as_tensor(G), torch.as_tensor(inc)), rtol=1e-9, atol=1e-11)


# The D = 32 cases: the SV model's n = 249, n = 2 and n = 1023 at d = 30, 17
# and 32 (f64 keeps one prefix of a chunk and stages the rest back).
@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (300, 3, 2), (1025, 4, 3), (2, 2, 2),
                                     (40, 16, 16), (1101, 3, 2), (250, 30, 30), (3, 17, 17),
                                     (1024, 32, 32)])
def test_filter_scan_matches_plain(dev, T, dx, dy):
    lg, ys = _model(T, dx, dy, seed=3)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0u, P0u)
    _close(*_both(FS.filter_scan, (elems,), dev))


def _affine_inputs(T, d):
    rng = np.random.default_rng(1)
    return (torch.as_tensor(0.4 / np.sqrt(d) * rng.standard_normal((T, d, d))),
            torch.as_tensor(rng.standard_normal((T, d))))


# The one-launch scan: the main path's n = 1024 at d = 16, one chunk (n = 1,
# 2), an empty chunk and n not a multiple of the chunk (n = 9, 50, 300),
# chunks longer than the kept prefixes (n = 1100), forward and reversed; the
# D = 32 instance at n = 250, 2 and 1023, d = 30, 17 and 32.
@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (1024, 16, True), (100, 4, False),
                                         (1024, 16, False), (300, 16, True), (1, 2, False),
                                         (2, 1, True), (9, 3, False), (1100, 2, True),
                                         (250, 30, True), (2, 17, False), (1023, 32, True)])
def test_affine_scan_matches_plain(dev, T, d, reverse):
    _close(*_both(FS.affine_scan, _affine_inputs(T, d) + (reverse,), dev))


def test_scans_on_two_streams_equal_one_stream(dev):
    """Filter and affine scans interleaved on two streams for 50 rounds:
    each output bit for bit that of the same call alone on one stream (each
    stream has its own hand-over state)."""
    lg, ys = _model(1024, 16, 16, seed=5)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = (z.float().to(dev) for z in lg)
    ys = ys.float().to(dev)
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0u, P0u)
    gains, incs = (z.float().to(dev) for z in _affine_inputs(1024, 16))
    alone = {"filter": FS.filter_scan(elems), "affine": FS.affine_scan(gains, incs, True)}
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for r in range(50):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                for kind in (("filter", "affine") if (r + i) % 2 else ("affine", "filter")):
                    outs.append((kind, FS.filter_scan(elems) if kind == "filter"
                                 else FS.affine_scan(gains, incs, True)))
    torch.cuda.synchronize()
    for kind, out in outs:
        for g, w in zip(out, alone[kind]):
            assert torch.equal(g, w), kind


def test_rejects_what_the_kernels_do_not_take(dev):
    b = torch.zeros(8, 33, device=dev)
    with pytest.raises(ValueError, match="dimensions"):
        FS.affine_scan(torch.zeros(8, 33, 33, device=dev), b)
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


@pytest.mark.parametrize("dtype,d", [(torch.float64, 33), (torch.float32, 49)])
def test_wide_instance_rejects_d33(dev, dtype, d):
    """Past the dtype's last instance (D = 32 in float64, D = 48 in float32)
    every MH wrapper raises on the card: no plain fallback."""
    n = 4
    F = torch.zeros(n, d, d, dtype=dtype, device=dev)
    v = torch.zeros(n, d, dtype=dtype, device=dev)
    calls = {"make_elements": lambda: KF.make_elements(F, F, v, F, F, v, v, v, F),
             "ell": lambda: KF.ell(F, F, v, F, F, v, v, v, F),
             "backward_maps": lambda: KF.backward_maps(F, F, v, v, F, v),
             "logdensity_steps": lambda: KF.logdensity_steps(F, F, v, F, F, v, v, v, v),
             "filter_scan": lambda: FS.filter_scan((F, v, F, v, F)),
             "affine_scan": lambda: FS.affine_scan(F, v)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="dimensions"):
            call()


def _nrel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


# The float32 D = 48 instance (no float64 one: past d = 32 float64 takes the
# plain versions) on random models at the SV width d = 40 with a share of the
# observations missing, at the edges 33 and 48 with dx != dy, each kernel in
# float32 on the card against its plain version in float64 on the CPU on the
# same values, at chip_smoke.NREL_F32 (random well-conditioned models: the
# float32 plain version itself lies ~1e-6 from float64 there); and C = 3
# chains of the dense batched layout, each chain bit-equal to a one-chain
# launch.
@pytest.mark.parametrize("T,dx,dy,nan_frac", [(128, 40, 40, 0.2), (20, 33, 48, 0.0),
                                              (20, 48, 7, 0.3)])
def test_d48_instance_matches_plain_f32(dev, T, dx, dy, nan_frac):
    f32 = torch.float32
    lg, ys, args = _element_inputs(T, dx, dy, nan_frac)
    Fs, Qs, bs, *obs = (z.to(f32).double() for z in args[:7])
    n = T - 1
    ms, Ps, _ = filtering(ys, lg, parallel=True)
    ms, Ps = ms[:-1].to(f32).double(), Ps[:-1].to(f32).double()
    eps = torch.as_tensor(np.random.default_rng(1).standard_normal((n, dx))).to(f32).double()
    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((T, dx))).to(f32).double()
    elems = tuple(z.to(f32).double() for z in _make_associative_elements(
        *args[:7], *(z.double() for z in args[7:])))
    gains = 0.4 / np.sqrt(dx) * torch.as_tensor(
        np.random.default_rng(3).standard_normal((n, dx, dx))).to(f32).double()
    calls = {KF.make_elements: (Fs, Qs, bs, *obs, *(z.to(f32).double() for z in args[7:])),
             KF.ell: (Fs, Qs, bs, *obs, ms, Ps),
             KF.backward_maps: (Fs, Qs, bs, ms, Ps, eps),
             KF.logdensity_steps: (Fs, Qs, bs, *obs, xs[:-1], xs[1:]),
             FS.filter_scan: (elems,),
             FS.affine_scan: (gains, eps, True)}
    for fn, fargs in calls.items():
        want = fn(*fargs)
        before = fn.launches
        got = fn(*(_to(tuple(z.to(f32) for z in a) if isinstance(a, tuple) else
                       a.to(f32) if isinstance(a, torch.Tensor) else a, dev) for a in fargs))
        torch.cuda.synchronize()
        assert fn.launches == before + 1, fn.__name__
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == f32 and bool(torch.isfinite(g).all()), fn.__name__
            assert _nrel(g.cpu(), w) <= 1e-4, (fn.__name__, _nrel(g.cpu(), w))
    # C = 3 chains: F, Q and b shared (expanded views), the rest each chain's.
    C = 3
    one_chain = tuple(z.to(f32).to(dev) for z in (Fs, Qs, bs))
    shared = tuple(z[:, None].expand((n, C) + z.shape[1:]) for z in one_chain)
    scale = torch.tensor([1.0, 0.9, 1.1], dtype=f32, device=dev)[:, None]
    own = (ms.to(f32).to(dev)[:, None] * scale, Ps.to(f32).to(dev)[:, None].expand(
        n, C, dx, dx).contiguous(), eps.to(f32).to(dev)[:, None] * scale)
    G, inc = KF.backward_maps(*shared, *own)
    for c in range(C):
        one = KF.backward_maps(*one_chain, *(z[:, c].contiguous() for z in own))
        assert torch.equal(G[:, c], one[0]) and torch.equal(inc[:, c], one[1]), c


@pytest.mark.parametrize("order", [1, 2])
def test_sv_kalman_step_matches_cpu(dev, order):
    """Three SV kalman steps (T=32, D=30: the D = 32 instance) on the card,
    float64, against the CPU given the same noise: identical accepts, and
    each of the six kernels launched as the MH step launches it."""
    T, D = 32, 30
    xs, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(21),
                         device="cpu")
    out = {}
    for where in ("cpu", dev):
        init, kernel = sv.get_kalman_kernel(ys.to(where), *SV_PARAMS, True, order)
        rng = np.random.default_rng(order)
        state = init(xs.to(where))
        K.reset_launches()
        steps = []
        for _ in range(3):
            noise = (torch.as_tensor(rng.standard_normal((T, D)), device=where),
                     torch.as_tensor(rng.standard_normal((T, D)), device=where),
                     torch.as_tensor(rng.uniform(), dtype=torch.float64, device=where))
            state = kernel(state, 0.05, noise=noise)
            steps.append((state.x.cpu(), bool(state.updated), float(state.log_target)))
        out[str(where)] = steps
    launches = K.launches()
    for name, per_step in (("make_elements", 2), ("filter_scan", 2), ("ell", 2),
                           ("backward_maps", 1), ("affine_scan", 1), ("logdensity_steps", 2)):
        assert launches[name] == 3 * per_step, name
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


def _factor_launches(N):
    """A factor sweep's launches: at N <= 32 the pair scores, then the sweep
    on one warp; past it the block sweep alone."""
    return 2 if N <= 32 else 1


@pytest.mark.parametrize("n,N,k,pgas", [(23, 32, 2, False), (23, 32, 2, True),
                                        (9, 300, 30, False), (5, 4096, 1, True),
                                        (1023, 25, 64, False), (1023, 25, 64, True),
                                        (249, 25, 30, False), (249, 25, 30, True),
                                        (100, 1, 8, True), (100, 32, 64, True)])
def test_forward_factor_matches_plain(dev, n, N, k, pgas):
    _close(*_both(CF.forward_factor_scan, _factor_inputs(n, N, k, seed=N) + (pgas,), dev,
                  _factor_launches(N)))


@pytest.mark.parametrize("n,N,k", [(19, 16, 3), (24, 25, 30), (6, 4096, 1), (1023, 25, 64),
                                   (249, 25, 30), (100, 1, 8), (100, 32, 64)])
def test_backward_factor_matches_plain(dev, n, N, k):
    rf, cf, rb, lw, _, us, _ = _factor_inputs(n, N, k, seed=k)
    _close(*_both(CF.backward_factor_scan, (rf, cf, rb, lw, us, torch.tensor(min(3, N - 1))),
                  dev, _factor_launches(N)))


@pytest.mark.parametrize("T,D,N", [(12, 3, 16), (40, 30, 25), (9, 30, 1024), (9, 30, 100),
                                   (6, 70, 25)])
def test_block_lane_matches_plain(dev, T, D, N):
    """Each path of the sweep (test_torch_csrc_host.py test_host_block_lane_
    staged_plan): staged with the one-warp carry (N <= 32), staged with the
    block collectives (N = 100), particles in global memory (N = 1024); and
    D = 70, past the 64 components of the spatial functor's registers (the
    SV functor keeps none there)."""
    _, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(T),
                        device="cpu")
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
    xs, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(5),
                         device="cpu")
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
    assert CF.backward_factor_scan.launches == before + _factor_launches(N) * len(noises)
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)


# --------------------------------------------------------------------------
# The lane sweep and the scalar-state particle-Gibbs steps
# --------------------------------------------------------------------------

def _lane_model(model, T, where):
    """(Mt, Gt) of a model with lane callables, float64 on `where`."""
    from aux_ssm_tpu_torch.models import ar1_gauss, rare_event, theta_logistic
    rng = np.random.default_rng(T)
    if model == "theta_logistic":
        return theta_logistic.get_feynman_kac(
            torch.as_tensor(1.0 + 0.3 * rng.standard_normal((T, 1))).to(where))[2:]
    if model == "ar1_gauss":
        return ar1_gauss.get_feynman_kac(
            torch.as_tensor(rng.standard_normal((T - 1, 1))).to(where))[2:]
    if model == "rare_event_bootstrap":
        return rare_event.get_feynman_kac(5.0, 0.8, 0.5, T, device=where)[2:]
    captured = {}
    with pytest.MonkeyPatch.context() as mp:  # the factory, from where csmc_aux receives it
        mp.setattr(rare_event.csmc_aux, "get_kernel",
                   lambda factory, *a, **k: captured.setdefault("factory", factory))
        rare_event.get_guided_csmc_kernel(5.0, 0.8, 0.5, T, 8, gradient=model.endswith("grad"),
                                          device=where)
    return captured["factory"](torch.as_tensor(rng.standard_normal((T, 1))).to(where),
                               torch.as_tensor(rng.uniform(0.3, 0.9, T)).to(where))[2:]


@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("model,T,N", [
    ("theta_logistic", 24, 32), ("theta_logistic", 40, 256), ("theta_logistic", 5, 8192),
    ("rare_event_guided", 2, 25), ("rare_event_guided_grad", 9, 16),
    ("rare_event_bootstrap", 9, 16), ("ar1_gauss", 12, 4096), ("theta_logistic", 24, 1),
    ("theta_logistic", 24, 33), ("ar1_gauss", 12, 1024)])
def test_lane_matches_plain(dev, model, T, N, pgas):
    n = T - 1
    rng = np.random.default_rng(N)
    w0 = rng.uniform(0.1, 1.0, N)
    inputs = tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((n, N)), rng.uniform(size=(n, N)), rng.uniform(size=n),
        1.0 + 0.5 * rng.standard_normal(n), 1.0 + 0.5 * rng.standard_normal(N), w0 / w0.sum()))
    out = []
    for where in ("cpu", dev):
        Mt, Gt = _lane_model(model, T, where)
        before = CF.lane_scan.launches
        out.append(tuple(z.cpu() for z in CF.lane_scan(Mt, Gt, Mt if pgas else None,
                                                       *_to(inputs, where))))
    assert CF.lane_scan.launches == before + 1
    assert torch.equal(out[1][2], out[0][2])
    _close(out[1][:2], out[0][:2])


@pytest.mark.parametrize("ancestor_sampling", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_theta_logistic_step_matches_cpu(dev, ancestor_sampling, backward):
    """Two f64 PGAS steps (T=24, N=32) on the card against the CPU, given the
    same noise; the card's steps launch the lane sweep."""
    from aux_ssm_tpu_torch.models import theta_logistic as tl
    T, N = 24, 32
    xs, ys = tl.get_data(T, generator=torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(2)
    noises = [tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((N, 1)), rng.uniform(size=(T - 1, N)),
        rng.standard_normal((T - 1, N, 1)), rng.uniform(size=T - 1), rng.uniform(size=T)))
        for _ in range(2)]
    out = []
    for where in ("cpu", dev):
        init, kernel = tl.get_pgas_kernel(ys.to(where), N, backward=backward,
                                          ancestor_sampling=ancestor_sampling)
        state = init(xs.to(where))
        before = CF.lane_scan.launches
        steps = []
        for noise in noises:
            state = kernel(state, noise=_to(noise, where))
            steps.append((state.x.cpu(), state.updated.cpu()))
        out.append(steps)
    assert CF.lane_scan.launches == before + len(noises)
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("T", [2, 6])
@pytest.mark.parametrize("style", ["kalman", "kalman-grad", "csmc", "csmc-guided",
                                   "csmc-guided-grad"])
def test_rare_event_step_matches_cpu(dev, style, T):
    """Two f64 steps of each rare-event style on the card against the CPU,
    given the same noise; T = 2 is the published grid's one-step sweep, and
    kalman runs the scalar scans at M = 1."""
    from aux_ssm_tpu_torch.models import rare_event as rev
    N = 25
    gradient = style.endswith("-grad")
    rng = np.random.default_rng(T)
    x0 = torch.as_tensor(rng.standard_normal((T, 1)) + 3.0)
    if style.startswith("kalman"):
        delta = 0.7
        noises = [(rng.standard_normal((T, 1)), rng.standard_normal((T, 1)), rng.uniform())
                  for _ in range(2)]
    else:
        delta = torch.as_tensor(rng.uniform(0.3, 1.5, T))
        noises = [(rng.standard_normal((T, 1)), rng.standard_normal((N, 1)),
                   rng.uniform(size=(T - 1, N)), rng.standard_normal((T - 1, N, 1)),
                   rng.uniform(size=T - 1), rng.uniform(size=T)) for _ in range(2)]
    out = []
    for where in ("cpu", dev):
        kw = dict(dtype=torch.float64, device=where)
        if style.startswith("kalman"):
            init, kernel = rev.get_kalman_kernel(5.0, 0.8, 0.5, T, True, gradient=gradient, **kw)
        elif style.startswith("csmc-guided"):
            init, kernel = rev.get_guided_csmc_kernel(5.0, 0.8, 0.5, T, N, gradient=gradient,
                                                      **kw)
        else:
            init, kernel = rev.get_csmc_kernel(5.0, 0.8, 0.5, T, N, **kw)
        state = init(x0.to(where))
        steps = []
        for noise in noises:
            noise = tuple(torch.as_tensor(z, dtype=torch.float64, device=where) for z in noise)
            state = kernel(state, _to(delta, where), noise=noise)
            steps.append((state.x.cpu(), state.updated.cpu()))
        out.append(steps)
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)


# --------------------------------------------------------------------------
# The scalar scans and the spatio-temporal Student-t steps
# --------------------------------------------------------------------------

SP_PARAMS = (0.3, 4.0, -0.25, 1)  # sigma_x, nu, tau, r_y


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9), (torch.float32, 2e-5)])
@pytest.mark.parametrize("n,B", [(1, 5), (37, 1), (100, 36), (299, 64), (513, 130), (1023, 64),
                                 (1024, 4096), (50, 601), (517, 2051), (2100, 65), (1023, 1057)])
def test_scalar_scans_match_plain(dev, n, B, dtype, rtol):
    """Both scalar scans (the affine one forward and reversed) on the card
    against their plain versions on the CPU; float32 at the JAX package's own
    kernel-vs-XLA bound. The block layout's edges on 132 SMs: B not a
    multiple of the columns a block (601 and 1057 at 2 or 4, 2051 at 4 in
    float32), n below the chunk count (50), n not a multiple of the chunk
    length (517: chunks of 5), and chunks past one window of 8 steps (2100:
    17 a chunk)."""
    SS = K.scalar_scan
    rng = np.random.default_rng(n + B)
    elems = tuple(torch.as_tensor(z, dtype=dtype) for z in (
        rng.uniform(0.5, 1.0, (n, B)), rng.standard_normal((n, B)), rng.uniform(0.1, 1.0, (n, B)),
        rng.standard_normal((n, B)), rng.uniform(0.0, 0.5, (n, B))))
    _close(*_both(SS.scalar_filter_scan, (elems,), dev), rtol=rtol, atol=rtol)
    gains = torch.as_tensor(rng.uniform(-0.9, 0.9, (n, B)), dtype=dtype)
    for reverse in (False, True):
        _close(*_both(SS.scalar_affine_scan, (gains, elems[1], reverse), dev), rtol=rtol,
               atol=rtol)


def test_scalar_scans_reject_what_the_kernel_does_not_take(dev):
    SS = K.scalar_scan
    g = torch.zeros(8, 3, device=dev)
    with pytest.raises(TypeError):
        SS.scalar_affine_scan(g.half(), g.half())
    with pytest.raises(ValueError, match="must be on"):
        SS.scalar_affine_scan(torch.zeros(8, 3), g)
    strided = torch.zeros(8, 6, device=dev)[:, ::2]  # made contiguous by the wrapper
    assert SS.scalar_affine_scan(strided, g)[1].shape == (8, 3)


@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("T,D,N", [(12, 2, 16), (9, 3, 25), (20, 8, 25), (5, 8, 1024),
                                   (9, 8, 64), (9, 9, 25), (6, 9, 64), (5, 9, 1024)])
def test_block_lane_spatial_matches_plain(dev, T, D, N, gradient):
    """Staged with the one-warp carry (N <= 32), staged with the block
    collectives (N = 64), particles in global memory (N = 1024); at d = 64
    the lanes' components in registers, at d = 81 in shared memory."""
    from aux_ssm_tpu_torch.models import spatial
    sigma_x, nu, tau, r_y = SP_PARAMS
    rng = np.random.default_rng(T + D)
    d, n = D * D, T - 1
    _, ys = spatial.get_data(rng, sigma_x, r_y, tau, nu, D, T, device="cpu")
    inputs = tuple(torch.as_tensor(z) for z in (
        ys.numpy() + 0.3 * rng.standard_normal((T, d)), rng.uniform(0.2, 0.6, size=T),
        rng.standard_normal((n, d, N)), rng.uniform(size=(n, N)),
        ys[1:].numpy() + 0.3 * rng.standard_normal((n, d)),
        ys[0].numpy()[:, None] + 0.3 * rng.standard_normal((d, N)), np.full(N, 1.0 / N)))
    out = []
    for where in ("cpu", dev):
        u, scale, *sweep = (z.to(where) for z in inputs)
        factory, _ = spatial.make_guided_factory(ys.to(where), sigma_x, nu, tau, r_y, D, gradient)
        _, _, Mt, Gt = factory(u, scale)
        before = CF.block_lane_scan.launches
        out.append(tuple(z.cpu() for z in CF.block_lane_scan(Mt, Gt, *sweep)))
    assert CF.block_lane_scan.launches == before + 1
    assert torch.equal(out[1][2], out[0][2])
    _close(out[1][:2], out[0][:2])


@pytest.mark.parametrize("style", ["kalman-1", "kalman-2", "csmc", "csmc-grad", "csmc-guided",
                                   "csmc-guided-grad"])
def test_spatial_step_matches_cpu(dev, style):
    """Two f64 steps of each spatial style (T=32, a 3 x 3 grid, N=16, backward
    sampling) on the card against the CPU, given the same noise; a kalman step
    launches the scalar scans (2 + 1) and none of the d x d kernels."""
    from aux_ssm_tpu_torch.models import spatial
    sigma_x, nu, tau, r_y = SP_PARAMS
    T, D, N = 32, 3, 16
    B = D * D
    rng = np.random.default_rng(14)
    xs, ys = spatial.get_data(rng, sigma_x, r_y, tau, nu, D, T, device="cpu")
    x0 = xs + torch.as_tensor(0.2 * rng.standard_normal((T, B)))
    gradient = style.endswith("-grad")
    if style.startswith("kalman"):
        delta = 0.05
        noises = [(rng.standard_normal((T, B, 1)), rng.standard_normal((T, B, 1)), rng.uniform())
                  for _ in range(2)]
        want = {"scalar_filter_scan": 4, "scalar_affine_scan": 2}
    else:
        delta = torch.as_tensor(rng.uniform(0.05, 0.3, T))
        noises = [(rng.standard_normal((T, B)), rng.standard_normal((N, B)),
                   rng.uniform(size=(T - 1, N)), rng.standard_normal((T - 1, N, B)),
                   rng.uniform(size=T - 1), rng.uniform(size=T)) for _ in range(2)]
        guided = "guided" in style
        want = {"backward_factor_scan": 2 * _factor_launches(N),
                "block_lane_scan" if guided else "forward_factor_scan":
                    2 if guided else 2 * _factor_launches(N)}
    out = []
    for where in ("cpu", dev):
        common = (ys.to(where), sigma_x, nu, tau, r_y, D)
        if style.startswith("kalman"):
            init, kernel = spatial.get_kalman_kernel(*common, True, order=int(style[-1]))
        elif "guided" in style:
            init, kernel = spatial.get_guided_csmc_kernel(*common, N, backward=True,
                                                          gradient=gradient)
        else:
            init, kernel = spatial.get_csmc_kernel(*common, N, backward=True, gradient=gradient)
        state = init(x0.to(where))
        K.reset_launches()
        steps = []
        for noise in noises:
            noise = tuple(torch.as_tensor(z, dtype=torch.float64, device=where) for z in noise)
            state = kernel(state, _to(delta, where), noise=noise)
            steps.append((state.x.cpu(), state.updated.cpu()))
        out.append(steps)
    assert {k: v for k, v in K.launches().items() if v} == want
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)


def test_stencil_convolution_is_ieee_float32(dev):
    """The precision stencil goes through a library convolution: in float32
    on the card it must agree with the float64 apply to float32 rounding
    (TF32 would keep three digits); the package turns cuDNN's TF32 off at
    import."""
    from aux_ssm_tpu_torch.models import t_distribution as tdist
    from aux_ssm_tpu_torch.native.precision import precision_stencil
    assert torch.backends.cudnn.allow_tf32 is False
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal((1024, 25, 64)))
    stencil = torch.as_tensor(precision_stencil(-0.25, 1))
    want = tdist.apply_precision_stencil(v, stencil, 8)
    got = tdist.apply_precision_stencil(v.float().to(dev), stencil.float().to(dev), 8).cpu()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=2e-6)


# --------------------------------------------------------------------------
# The parallel-in-time stitching kernels and PIT steps
# --------------------------------------------------------------------------

def _stitch_factors(P, n, N, k, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return tuple(z.to(dtype) for z in (0.4 * torch.randn(P, n, k, generator=g, dtype=torch.float64),
                                       0.4 * torch.randn(P, N, k, generator=g, dtype=torch.float64),
                                       torch.randn(P, N, generator=g, dtype=torch.float64)))


@pytest.mark.parametrize("P,n,N,k", [(125, 25, 25, 30), (3, 130, 200, 1), (2, 40, 70, 64),
                                     (1, 4096, 4096, 1), (4, 9, 3, 8), (2, 300, 65, 17),
                                     (512, 25, 25, 64), (1, 25, 25, 64), (1, 25, 25, 30),
                                     (2, 40, 1500, 64), (600, 25, 200, 8), (64, 1000, 1000, 30),
                                     (64, 4, 4, 64), (64, 8, 8, 64), (64, 4, 4, 30),
                                     (2, 1000, 4, 64), (3, 20, 50, 8), (37, 4, 9, 1),
                                     (5, 10, 20, 64)])
def test_row_lse_and_col_sample_match_plain(dev, P, n, N, k):
    """Every feature bound (1, 8, 32, 64), ragged row blocks and column tiles,
    phase 16's shapes (N = 25 at levels 0 and the root, N = 4096's root), 4
    rows a thread with 8 threads a row (P = 600, 200 columns; a two-pass
    level at N = 1000 with 64 nodes), and the plans whose nodes a block or
    row slots shared memory caps (4-column tiles); both kernels run one
    plan, so these also give col_sample G = 1, 2, 4, 8, 16 (3, 20, 50, 8)
    and 32, R = 1, 2 and 4, and several nodes a block (37, 4, 9, 1 and 5,
    10, 20, 64);
    float64 values to 1e-12 and identical columns, float32 columns at >= 0.999
    (the scores are equal; only the float32 logs of exp sums differ)."""
    ST = K.stitching
    rf, cf, cb = _stitch_factors(P, n, N, k, seed=n + k)
    (want,), (got,) = _both(ST.row_lse, (rf, cf, cb), dev)
    _close((got,), (want,), rtol=1e-12, atol=1e-12)
    for seed, offset in ((-1, 0), (2 ** 31 - 1, 5)):
        (want,), (got,) = _both(ST.col_sample, (seed, rf, cf, cb, offset), dev)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    f32 = tuple(z.float() for z in (rf, cf, cb))
    (want,), (got,) = _both(ST.col_sample, (7,) + f32, dev)
    assert float((got == want).double().mean()) >= 0.999
    (want,), (got,) = _both(ST.row_lse, f32, dev)
    _close((got,), (want,), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_block_max", [False, True])
@pytest.mark.parametrize("P,n,N,k", [(4, 130, 256, 1), (2, 64, 384, 9), (1, 200, 4096, 1),
                                     (512, 40, 256, 1), (2, 64, 2048, 8), (1, 300, 4096, 30)])
def test_block_masses_match_plain(dev, P, n, N, k, per_block_max):
    """Every feature bound; the node whole in shared memory (k = 1) and tiled
    (k = 30 at N = 4096; k = 8 at N = 2048 in float64 only); P = 1 (one row a
    thread) and P = 512 (4 rows a thread, the last group ragged)."""
    ST = K.stitching
    rf, cf, cb = _stitch_factors(P, n, N, k, seed=N + k)
    cb[0, 128:256] = -900.0  # an underflowing block: -inf under the row max
    (want,), (got,) = _both(ST.block_masses, (rf, cf, cb, per_block_max), dev)
    assert bool(torch.isinf(got[0, :, 1]).all()) != per_block_max
    _close((got,), (want,), rtol=1e-12, atol=1e-12)
    f32 = tuple(z.float() for z in (rf, cf, cb))
    (want,), (got,) = _both(ST.block_masses, f32 + (per_block_max,), dev)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    _close((got[fin],), (want[fin],), rtol=2e-5, atol=2e-5)


def _draws_inputs(P, N, k, seed, dtype=torch.float64):
    """(row_logits, u_rows, Lb, rf, cf, cb) of one level's fused draws on the
    CPU, with -inf column biases (past N = 128 one whole block of node 0) and
    block masses."""
    rf, cf, cb = _stitch_factors(P, N, N, k, seed=seed)
    cb[:, [5, 77]] = -float("inf")
    if N > 128:
        cb[0, :128] = -float("inf")
    Lb = K.stitching.block_masses(rf, cf, cb)
    Lb[:, 3, -1] = -float("inf")
    g = torch.Generator().manual_seed(seed + 1)
    rl = torch.randn(P, N, generator=g, dtype=torch.float64) + torch.logsumexp(Lb, -1)
    u = torch.rand(P, N, generator=g, dtype=torch.float64)
    return tuple(z.to(dtype) for z in (rl, u, Lb, rf, cf, cb))


@pytest.mark.parametrize("P,N,k", [(3, 256, 2), (2, 128, 1), (4, 1024, 9), (1, 8192, 40)])
def test_stitch_draws_and_within_block_cols_match_plain(dev, P, N, k):
    """The fused draws and the joint draws' column stage, on every feature
    bound, nb = 1 and the widest N (f64: above 48 KB of shared memory):
    float64 indices identical, float32 indices equal at >= 0.999 (the same
    arithmetic; only exp and log may round otherwise)."""
    ST = K.stitching
    for dtype in (torch.float64, torch.float32):
        draws = _draws_inputs(P, N, k, seed=N + k, dtype=dtype)
        want, got = _both(ST.stitch_draws, (-3,) + draws + (7,), dev)
        g = torch.Generator().manual_seed(k)
        blocks = torch.randint(0, N // 128, (P, 300), generator=g)
        rf_sel = torch.randn(P, 300, k, generator=g, dtype=torch.float64).to(dtype)
        (want_c,), (got_c,) = _both(ST.within_block_cols, (11, blocks, rf_sel) + draws[4:] + (2,),
                                    dev)
        for w, g_ in zip(want + (want_c,), got + (got_c,)):
            if dtype == torch.float64:
                np.testing.assert_array_equal(g_.numpy(), w.numpy())
            else:
                assert float((g_ == w).double().mean()) >= 0.999
        assert np.isfinite(draws[5].numpy()[np.arange(P)[:, None], got[1].numpy()]).all()


@pytest.mark.parametrize("C", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_draw_chain_instances_are_one_chain_launches(dev, C, dtype):
    """stitch_draws and within_block_cols with `chains` C (a seed a chain,
    the nodes chain after chain): the C-chain launch equals, chain by chain,
    one-chain launches with the chains' seeds bit for bit, in float32 and
    float64; in float64 also the plain chain twin on the CPU."""
    ST, per, N, k = K.stitching, 2, 256, 3
    P = C * per
    draws = _draws_inputs(P, N, k, seed=C, dtype=dtype)
    g = torch.Generator().manual_seed(C)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (C,), generator=g, dtype=torch.int64).to(
        torch.int32)
    blocks = torch.randint(0, N // 128, (P, 64), generator=g)
    rf_sel = draws[3][:, :64].contiguous()
    on = [z.to(dev) for z in draws]
    sd, bl, rs = seeds.to(dev), blocks.to(dev), rf_sel.to(dev)
    got = ST.stitch_draws(sd, *on, 5, chains=C)
    got_c = ST.within_block_cols(sd, bl, rs, *on[4:], 5, chains=C)
    for c in range(C):
        sl = slice(c * per, (c + 1) * per)
        one = ST.stitch_draws(sd[c], *(z[sl] for z in on), 5)
        one_c = ST.within_block_cols(sd[c], bl[sl], rs[sl], *(z[sl] for z in on[4:]), 5)
        assert all(torch.equal(a[sl], b) for a, b in zip(got + (got_c,), one + (one_c,)))
    if dtype == torch.float64:
        want = ST.stitch_draws(seeds, *draws, 5, chains=C)
        want_c = ST.within_block_cols(seeds, blocks, rf_sel, *draws[4:], 5, chains=C)
        for w, g_ in zip(want + (want_c,), got + (got_c,)):
            np.testing.assert_array_equal(g_.cpu().numpy(), w.numpy())


def test_blocked_pit_chains_step_matches_cpu(dev):
    """A batched blocked PIT step of C = 3 chains (SV D = 2, T = 8, N = 128,
    both draws modes), float64, on the card and on the CPU given the same
    noise: identical `updated`, states to rtol 1e-9; one launch of each
    stitching kernel a level."""
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind, pit
    from aux_ssm_tpu_torch.kernels.csmc_base import CSMCState, tree_map
    C, T, N = 3, 8, 128
    xs, ys = sv.get_data(0.0, 0.9, 2.0, 0.25, 2, T, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    x0 = xs.expand(C, -1, -1).clone()
    g = torch.Generator().manual_seed(4)
    noise = ((torch.randn(x0.shape, generator=g, dtype=torch.float64),
              torch.randn(C, T, N, 2, generator=g, dtype=torch.float64))
             + pit.draw_noise(T, N, x0, g, chains=C))
    delta = torch.full((C, T), 0.3, dtype=torch.float64)
    for draws in ("joint", "fused"):
        out = {}
        for where in ("cpu", dev):
            _, kernel = ind.get_kernel(*sv.get_feynman_kac(ys.to(where), 0.0, 0.9, 2.0, 0.25,
                                                           True), N, parallel=True,
                                       stitch="blocked", draws=draws)
            K.reset_launches()
            out[str(where)] = kernel(CSMCState(x=x0.to(where), updated=torch.zeros(
                C, T, dtype=torch.bool, device=where)), delta.to(where),
                noise=tuple(tree_map(lambda z: z.to(where), n) for n in noise))
        name = "stitch_draws" if draws == "fused" else "within_block_cols"
        assert K.launches()[name] == len(pit.level_sizes(T)) - 1
        np.testing.assert_array_equal(out[str(dev)].updated.cpu().numpy(),
                                      out["cpu"].updated.numpy())
        np.testing.assert_allclose(out[str(dev)].x.cpu().numpy(), out["cpu"].x.numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_wide_shapes_take_the_plain_routes_on_the_card(dev):
    """At D = 33 in float64 and D = 49 in float32 an SV kalman-1 step
    launches none of the d x d kernels and equals the CPU's (float64 to
    rtol 1e-9; float32 to 2e-3 absolute, what float32 moves the drawn path
    by at these widths: tests/test_torch_wide_routes.py); at d = 81 a
    spatial csmc-guided step launches the block-lane sweep once (its lanes'
    components in shared memory) and equals the CPU's."""
    from aux_ssm_tpu_torch.models import spatial
    T = 8
    g = torch.Generator().manual_seed(6)
    for dtype, D, tol in ((torch.float64, 33, dict(rtol=1e-9, atol=1e-12)),
                          (torch.float32, 49, dict(rtol=0, atol=2e-3))):
        xs, ys = (z.to(dtype) for z in sv.get_data(
            0.0, 0.9, 2.0, 0.25, D, T, generator=torch.Generator().manual_seed(5), device="cpu"))
        noise = (torch.randn(T, D, generator=g, dtype=dtype),
                 torch.randn(T, D, generator=g, dtype=dtype),
                 torch.rand((), generator=g, dtype=dtype))
        out = {}
        for where in ("cpu", dev):
            init, kernel = sv.get_kalman_kernel(ys.to(where), 0.0, 0.9, 2.0, 0.25, True, 1)
            K.reset_launches()
            out[str(where)] = kernel(init(xs.to(where)), 0.05,
                                     noise=tuple(z.to(where) for z in noise))
        assert not any(K.launches().values()), dtype
        assert bool(out[str(dev)].updated) == bool(out["cpu"].updated)
        np.testing.assert_allclose(out[str(dev)].x.cpu().numpy(), out["cpu"].x.numpy(), **tol)
    side, N = 9, 8
    sxs, sys_ = spatial.get_data(np.random.default_rng(7), 0.3, 1, -0.25, 4.0, side, 6,
                                 dtype=torch.float64, device="cpu")
    d = side * side
    noise = (torch.randn(6, d, generator=g, dtype=torch.float64),
             torch.randn(N, d, generator=g, dtype=torch.float64),
             torch.rand(5, N, generator=g, dtype=torch.float64),
             torch.randn(5, N, d, generator=g, dtype=torch.float64),
             torch.rand(5, generator=g, dtype=torch.float64),
             torch.rand(6, generator=g, dtype=torch.float64))
    for where in ("cpu", dev):
        init, kernel = spatial.get_guided_csmc_kernel(sys_.to(where), 0.3, 4.0, -0.25, 1, side,
                                                      N, backward=True)
        K.reset_launches()
        out[str(where)] = kernel(init(sxs.to(where)), torch.full((6,), 0.02, dtype=torch.float64,
                                                                  device=where),
                                 noise=tuple(z.to(where) for z in noise))
    assert K.launches()["block_lane_scan"] == 1 and K.launches()["backward_factor_scan"] > 0
    np.testing.assert_array_equal(out[str(dev)].updated.cpu().numpy(), out["cpu"].updated.numpy())
    np.testing.assert_allclose(out[str(dev)].x.cpu().numpy(), out["cpu"].x.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_draw_log_matches_logf(dev):
    """The draw kernels' float32 log equals logf bit for bit on every
    positive normal float (the only arguments the draws give it)."""
    assert K.stitching.draw_log_mismatches(dev) == 0


def test_stitching_kernels_reject_what_they_do_not_take(dev):
    ST = K.stitching
    rf, cf, cb = (z.to(dev) for z in _stitch_factors(2, 8, 128, 65, seed=0))
    with pytest.raises(ValueError, match="dimensions"):
        ST.row_lse(rf, cf, cb)
    with pytest.raises(TypeError, match="float32 or float64|must be"):
        ST.row_lse(rf[..., :4].contiguous(), cf[..., :4].float().contiguous(), cb)
    draws = tuple(z.to(dev) for z in _draws_inputs(1, 128, 2, seed=0))
    with pytest.raises(TypeError, match="must be"):
        ST.stitch_draws(0, draws[0].float(), *draws[1:])
    big = torch.zeros(1, 8320, 1, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="multiple of 128 up to"):
        ST.within_block_cols(0, torch.zeros(1, 8320, dtype=torch.int64, device=dev), big, big,
                             big[..., 0])


@pytest.mark.parametrize("stitch,N", [("2pass", 25), ("blocked", 128), ("fused", 128)])
@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("model", ["sv", "spatial", "rare_event"])
def test_pit_step_matches_cpu(dev, model, gradient, stitch, N):
    """Two float64 PIT steps at T=37 on the card and on the CPU, given the
    same noise: identical `updated`, states to rtol 1e-9, and the card's
    steps launched the route's kernels (6 levels: the root's row_lse, and
    row_lse + col_sample, block_masses + within_block_cols or, with the fused
    draws, block_masses + stitch_draws at each of the other five)."""
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind, pit
    from aux_ssm_tpu_torch.models import rare_event as rev, spatial as sp
    T = 37
    route = stitch
    stitch, draws = ("blocked", "fused") if route == "fused" else (route, "joint")
    g = torch.Generator().manual_seed(3)
    if model == "sv":
        xs, ys = sv.get_data(0.0, 0.9, 2.0, 0.25, 3, T, generator=g, device="cpu")
        build = lambda where: ind.get_kernel(*sv.get_feynman_kac(ys.to(where), 0.0, 0.9, 2.0, 0.25),
                                             N, parallel=True, gradient=gradient, stitch=stitch,
                                             draws=draws)
    elif model == "spatial":
        xs, ys = sp.get_data(np.random.default_rng(3), 0.3, 1, -0.25, 4.0, 3, T, device="cpu")
        build = lambda where: ind.get_kernel(*sp.get_feynman_kac(ys.to(where), 0.3, 4.0, -0.25, 1, 3),
                                             N, parallel=True, gradient=gradient, stitch=stitch,
                                             draws=draws)
    else:
        xs = 3.0 + torch.randn(T, 1, generator=g, dtype=torch.float64)
        build = lambda where: ind.get_kernel(*rev.get_feynman_kac(5.0, 0.8, 0.5, T, device=where),
                                             N, parallel=True, gradient=gradient, stitch=stitch,
                                             draws=draws)
    d = xs.shape[1]
    delta = torch.full((T,), 0.02 if model == "spatial" else 0.2, dtype=torch.float64)
    noises = []
    for _ in range(2):
        eps_u, eps = torch.randn(T, d, generator=g), torch.randn(T, N, d, generator=g)
        levels, root = pit.draw_noise(T, N, eps, g)
        noises.append((eps_u.double(), eps.double(), [(u.double(), s) for u, s in levels],
                       tuple(u.double() for u in root)))
    runs = {}
    for where in ("cpu", dev):
        init, kernel = build(where)
        state = init(xs.to(where))
        K.reset_launches()
        for noise in noises:
            state = kernel(state, delta.to(where), noise=_to_tree(noise, where))
        runs[str(where)] = (state.x.cpu(), state.updated.cpu(), K.launches())
    (xc, uc, _), (xg, ug, launched) = runs["cpu"], runs[str(dev)]
    assert torch.equal(uc, ug)
    _close((xg,), (xc,))
    blocked = stitch == "blocked"
    want = {"row_lse": 2 * (1 if blocked else 6), "col_sample": 0 if blocked else 10,
            "block_masses": 10 if blocked else 0,
            "within_block_cols": 10 if route == "blocked" else 0,
            "stitch_draws": 10 if route == "fused" else 0}
    assert {k: launched[k] for k in want} == want


def _to_tree(z, where):
    if isinstance(z, (tuple, list)):
        return type(z)(_to_tree(v, where) for v in z)
    return z.to(where)


# --------------------------------------------------------------------------
# The block-lane sweep's chain axis and the batched SV and spatial steps
# --------------------------------------------------------------------------

def _block_lane_chain_inputs(model, C, T, D, N, gradient, where):
    """(Mt, Gt, eps, res_u, x_star, x0, w0) of C chains of a guided model on
    `where`: each chain with its own u, scales and operands."""
    from aux_ssm_tpu_torch.models import spatial
    rng = np.random.default_rng(C + T + D + N)
    if model == "sv":
        d = D
        _, ys = sv.get_data(*SV_PARAMS, D, T, generator=torch.Generator().manual_seed(T),
                            device="cpu")
        factory, _ = sv.make_guided_factory(ys.to(where), *SV_PARAMS, gradient)
        base = np.zeros((T, d))
    else:
        d = D * D
        _, ys = spatial.get_data(rng, *SP_PARAMS[:1], SP_PARAMS[3], SP_PARAMS[2], SP_PARAMS[1],
                                 D, T, device="cpu")
        factory, _ = spatial.make_guided_factory(ys.to(where), *SP_PARAMS, D, gradient)
        base = ys.numpy()
    n = T - 1
    w0 = rng.uniform(0.1, 1.0, (C, N))
    z = [base + 0.3 * rng.standard_normal((C, T, d)), rng.uniform(0.2, 0.6, (C, T)),
         rng.standard_normal((C, n, d, N)), rng.uniform(size=(C, n, N)),
         base[1:] + 0.3 * rng.standard_normal((C, n, d)),
         base[0][:, None] + 0.3 * rng.standard_normal((C, d, N)), w0 / w0.sum(1, keepdims=True)]
    u, scale, *sweep = (torch.as_tensor(v).to(where) for v in z)
    _, _, Mt, Gt = factory(u, scale)
    return (Mt, Gt, *sweep)


@pytest.mark.parametrize("model,C,T,D,N,gradient", [
    ("sv", 3, 12, 3, 16, False), ("sv", 4, 9, 30, 100, False), ("sv", 2, 9, 30, 1024, False),
    ("spatial", 3, 9, 3, 25, False), ("spatial", 5, 12, 8, 25, True),
    ("spatial", 2, 5, 8, 1024, True), ("spatial", 3, 7, 9, 25, True)])
def test_block_lane_chain_axis(dev, model, C, T, D, N, gradient):
    """C chains in one launch (each path: staged with the one-warp carry,
    staged with the block collectives, particles in global memory): the plain
    version chain by chain to rtol 1e-9 with identical ancestors, each chain
    bit-equal to a one-chain launch on its inputs, C = 1 to the call without
    a chain axis."""
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    want = CF.block_lane_scan(*_block_lane_chain_inputs(model, C, T, D, N, gradient, "cpu"))
    Mt, Gt, *sweep = _block_lane_chain_inputs(model, C, T, D, N, gradient, dev)
    before = CF.block_lane_scan.launches
    got = CF.block_lane_scan(Mt, Gt, *sweep)
    assert CF.block_lane_scan.launches == before + 1
    assert torch.equal(got[2].cpu(), want[2])
    _close(tuple(z.cpu() for z in got[:2]), want[:2])
    for c in range(C):
        one = [dataclasses.replace(m, params=tree_map(lambda z: z[c], m.params))
               for m in (Mt, Gt)]
        single = CF.block_lane_scan(*one, *(z[c] for z in sweep))
        assert all(torch.equal(g[c], s) for g, s in zip(got, single))
        if c == 0:
            unit = [dataclasses.replace(m, params=tree_map(lambda z: z[:1], m.params))
                    for m in (Mt, Gt)]
            first = CF.block_lane_scan(*unit, *(z[:1] for z in sweep))
            assert all(torch.equal(f[0], s) for f, s in zip(first, single))


def test_block_lane_chain_axis_rejects_broadcast_operands(dev):
    """A per-chain operand broadcast over the chains (stride 0) raises."""
    Mt, Gt, eps, res_u, x_star, x0, w0 = _block_lane_chain_inputs("sv", 3, 9, 3, 16, False, dev)
    with pytest.raises(ValueError, match="broadcast over the chains"):
        CF.block_lane_scan(Mt, Gt, eps, res_u, x_star[:1].expand(3, -1, -1), x0, w0)


@pytest.mark.parametrize("model,style", [("sv", "csmc"), ("sv", "csmc-guided"),
                                         ("spatial", "kalman-1"), ("spatial", "kalman-2"),
                                         ("spatial", "csmc"), ("spatial", "csmc-guided")])
def test_chain_steps_match_cpu(dev, model, style):
    """Two f64 batched steps of C = 3 chains (`chains=True`, T=16; SV D=3,
    spatial 3 x 3, N=16) on the card against the CPU, given the same noise;
    the kernels launch as often as for one chain's step."""
    from aux_ssm_tpu_torch.kernels import csmc as csmc_mod, pit
    from aux_ssm_tpu_torch.models import spatial
    C, T, N = 3, 16, 16
    rng = np.random.default_rng(20)
    if model == "sv":
        xs, ys = sv.get_data(*SV_PARAMS, 3, T, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    else:
        xs, ys = spatial.get_data(rng, *SP_PARAMS[:1], SP_PARAMS[3], SP_PARAMS[2], SP_PARAMS[1],
                                  3, T, device="cpu")
    x0 = xs + torch.as_tensor(0.1 * rng.standard_normal((C,) + tuple(xs.shape)))
    gen = torch.Generator().manual_seed(2)
    if style.startswith("kalman"):
        x0, delta = x0[..., None], torch.full((C,), 0.05, dtype=torch.float64)
        noises = [(torch.randn(x0.shape, generator=gen, dtype=torch.float64),
                   torch.randn(x0.shape, generator=gen, dtype=torch.float64),
                   torch.rand(C, generator=gen, dtype=torch.float64)) for _ in range(2)]
    else:
        delta = torch.as_tensor(rng.uniform(0.05, 0.3, (C, T)))
        if style == "csmc":
            noises = [(torch.randn(x0.shape, generator=gen, dtype=torch.float64),
                       torch.randn(C, T, N, x0.shape[-1], generator=gen, dtype=torch.float64))
                      + pit.draw_noise(T, N, x0, gen, chains=C) for _ in range(2)]
        else:
            noises = [(torch.randn(x0.shape, generator=gen, dtype=torch.float64),)
                      + csmc_mod.draw_noise(x0, N, csmc_mod.resampling_mod.multinomial, gen)
                      for _ in range(2)]
    out, counts = [], []
    for where in ("cpu", dev):
        if model == "sv":
            get = sv.get_csmc_kernel if style == "csmc" else sv.get_guided_csmc_kernel
            kw = dict(parallel=True) if style == "csmc" else dict(backward=True)
            init, kernel = get(ys.to(where), *SV_PARAMS, N, chains=True, **kw)
        elif style.startswith("kalman"):
            init, kernel = spatial.get_kalman_kernel(ys.to(where), *SP_PARAMS, 3,
                                                     style == "kalman-1",
                                                     order=int(style[-1]), chains=True)
        else:
            get = spatial.get_csmc_kernel if style == "csmc" else spatial.get_guided_csmc_kernel
            kw = dict(parallel=True) if style == "csmc" else dict(backward=True)
            init, kernel = get(ys.to(where), *SP_PARAMS, 3, N, chains=True, **kw)
        assert kernel.chain_axis
        state = init(x0.to(where))
        K.reset_launches()
        steps = []
        for noise in noises:
            state = kernel(state, delta.to(where), noise=_to_tree(noise, where))
            steps.append((state.x.cpu(), state.updated.cpu()))
        out.append(steps)
        counts.append({k: v for k, v in K.launches().items() if v})
    for (xc, uc), (xg, ug) in zip(*out):
        assert torch.equal(uc, ug)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-9, atol=1e-11)
    want = {"kalman-1": {"scalar_filter_scan": 4, "scalar_affine_scan": 2}, "kalman-2": {},
            "csmc": {"row_lse": 8, "col_sample": 6},
            "csmc-guided": {"block_lane_scan": 2, "backward_factor_scan": 4}}[style]
    assert counts[1] == want
