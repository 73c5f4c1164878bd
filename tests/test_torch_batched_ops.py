"""The port's ops in the batched scalar layout (B independent filters with
dx = dy = 1: ys (T, B, 1), m0 (B, 1), P0 (B, 1, 1), Fs/Qs (T-1, B, 1, 1),
bs (T-1, B, 1), Hs/Rs (T, B, 1, 1), cs (T, B, 1)) against `aux_ssm_tpu.ops`
on the same float64 inputs and the same noise.

Tolerance: the same scalar algebra on both sides; the port scans in its
kernel's chunk order and JAX with `associative_scan`, so they agree to
~1e-12, and rtol 1e-9 catches any wrong term.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops import lgssm as jl  # noqa: E402
from aux_ssm_tpu_torch.kernels.kalman import get_kernel  # noqa: E402
from aux_ssm_tpu_torch.ops import lgssm as tl  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS  # noqa: E402
from aux_ssm_tpu_torch.ops.filtering import filtering  # noqa: E402
from aux_ssm_tpu_torch.ops.sampling import sampling  # noqa: E402

JF = importlib.import_module("aux_ssm_tpu.ops.filtering")
JS = importlib.import_module("aux_ssm_tpu.ops.sampling")


def _model(T, B, seed, nan_frac=0.0):
    """A random batched scalar LGSSM and observations simulated from it."""
    rng = np.random.default_rng(seed)
    m0 = rng.standard_normal((B, 1))
    P0 = rng.uniform(0.5, 1.5, (B, 1, 1))
    Fs = rng.uniform(0.5, 1.1, (T - 1, B, 1, 1))
    Qs = rng.uniform(0.05, 0.5, (T - 1, B, 1, 1))
    bs = 0.1 * rng.standard_normal((T - 1, B, 1))
    Hs = rng.uniform(0.5, 1.5, (T, B, 1, 1))
    Rs = rng.uniform(0.1, 0.6, (T, B, 1, 1))
    cs = 0.1 * rng.standard_normal((T, B, 1))
    x = m0 + np.sqrt(P0[..., 0]) * rng.standard_normal((B, 1))
    ys = []
    for t in range(T):
        if t:
            noise = np.sqrt(Qs[t - 1, ..., 0]) * rng.standard_normal((B, 1))
            x = Fs[t - 1, ..., 0] * x + bs[t - 1] + noise
        ys.append(Hs[t, ..., 0] * x + cs[t] + np.sqrt(Rs[t, ..., 0]) * rng.standard_normal((B, 1)))
    ys = np.stack(ys)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    params = (m0, P0, Fs, Qs, bs, Hs, Rs, cs)
    j = (jl.LGSSM(*map(jnp.asarray, params)), jnp.asarray(ys))
    t = (tl.LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys))
    return j, t


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("T,B,nan_frac", [(40, 9, 0.0), (64, 4, 0.1), (300, 5, 0.05),
                                          (2, 6, 0.0)])
def test_batched_filtering_matches_jax(parallel, T, B, nan_frac):
    (jlg, jys), (tlg, tys) = _model(T, B, seed=T + B, nan_frac=nan_frac)
    want = JF.filtering(jys, jlg, parallel)
    got = filtering(tys, tlg, parallel)
    assert got[0].shape == (T, B, 1) and got[1].shape == (T, B, 1, 1) and got[2].ndim == 0
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("T,B", [(40, 9), (130, 4), (2, 3)])
def test_batched_sampling_matches_jax_given_noise(parallel, T, B):
    (jlg, jys), (tlg, tys) = _model(T, B, seed=7, nan_frac=0.1)
    ms, Ps, _ = JF.filtering(jys, jlg, parallel)
    key = jax.random.key(3)
    eps = jax.random.normal(key, ms.shape, ms.dtype)  # what JS.sampling draws
    want = JS.sampling(key, ms, Ps, jlg, parallel)
    got = sampling(torch.as_tensor(np.array(eps)), torch.as_tensor(np.array(ms)),
                   torch.as_tensor(np.array(Ps)), tlg, parallel)
    assert got.shape == (T, B, 1)
    _close(got, want)


@pytest.mark.parametrize("T,B,nan_frac", [(30, 9, 0.0), (50, 4, 0.2)])
def test_batched_densities_match_jax(T, B, nan_frac):
    (jlg, jys), (tlg, tys) = _model(T, B, seed=11, nan_frac=nan_frac)
    xs = np.random.default_rng(12).standard_normal((T, B, 1))
    jx, tx = jnp.asarray(xs), torch.as_tensor(xs)
    _close(tl.log_likelihood(tys, tx, tlg), jl.log_likelihood(jys, jx, jlg))
    _close(tl.prior_logpdf(tx, tlg), jl.prior_logpdf(jx, jlg))
    _close(tl.trajectory_logdensity(tys, tx, tlg), jl.trajectory_logdensity(jys, jx, jlg))
    _close(tl.posterior_logpdf(tys, tx, torch.tensor(1.5, dtype=torch.float64), tlg),
           jl.posterior_logpdf(jys, jx, 1.5, jlg))
    _close(tl.make_target_logpdf(tys, tlg)(tx), jl.make_target_logpdf(jys, jlg)(jx))


def test_batched_layout_goes_through_the_scalar_scans_only(monkeypatch):
    """A parallel filter pass and a draw in the batched layout call the two
    scalar scans once each and none of the d x d wrappers; the auxiliary
    Kalman kernel needs no change for the layout (its sums run over all
    axes) and one step is two filter scans and one affine scan."""
    calls = dict.fromkeys(("scalar_filter_scan", "scalar_affine_scan", "dense"), 0)

    def counted(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    F_mod = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")
    S_mod = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")
    monkeypatch.setattr(F_mod, "scalar_filter_scan",
                        counted(SS.scalar_filter_scan, "scalar_filter_scan"))
    monkeypatch.setattr(S_mod, "scalar_affine_scan",
                        counted(SS.scalar_affine_scan, "scalar_affine_scan"))
    for mod, name in ((F_mod, "filter_scan"), (S_mod, "affine_scan"), (S_mod, "backward_maps")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "dense"))
    for name in ("make_elements", "ell", "logdensity_steps"):
        monkeypatch.setattr(KF, name, counted(getattr(KF, name), "dense"))
    monkeypatch.setattr(FS, "filter_scan", counted(FS.filter_scan, "dense"))

    T, B = 24, 6
    _, (tlg, tys) = _model(T, B, seed=5)
    ms, Ps, _ = filtering(tys, tlg, True)
    sampling(torch.zeros(T, B, 1, dtype=torch.float64), ms, Ps, tlg, True)
    assert calls == {"scalar_filter_scan": 1, "scalar_affine_scan": 1, "dense": 0}

    target = tl.make_target_logpdf(tys, tlg)
    init, kernel = get_kernel(
        lambda x: tlg[:5],
        lambda x, u, delta: (u, torch.ones_like(tlg.Hs), 0.5 * delta * torch.ones_like(tlg.Rs),
                             torch.zeros_like(tlg.cs)),
        target, parallel=True)
    calls.update(dict.fromkeys(calls, 0))
    state = init(torch.zeros(T, B, 1, dtype=torch.float64))
    state = kernel(state, 0.3, generator=torch.Generator().manual_seed(0))
    assert state.x.shape == (T, B, 1) and bool(torch.isfinite(state.x).all())
    assert calls == {"scalar_filter_scan": 2, "scalar_affine_scan": 1, "dense": 0}


def test_wider_batched_layout_raises():
    """A batched layout with d > 1 no longer raises: it is the dense batched
    layout (B chains of a wider model), and each of its filters equals the
    unbatched call on its slice: filtering (parallel and sequential),
    sampling and the trajectory density, summed or one a filter."""
    T, B, d = 5, 3, 2
    rng = np.random.default_rng(0)
    eye = torch.eye(d, dtype=torch.float64)
    lg = tl.LGSSM(torch.as_tensor(rng.standard_normal((B, d))), eye.expand(B, d, d),
                  0.5 * eye.expand(T - 1, B, d, d), eye.expand(T - 1, B, d, d),
                  torch.zeros(T - 1, B, d, dtype=torch.float64), eye.expand(T, B, d, d),
                  eye.expand(T, B, d, d), torch.zeros(T, B, d, dtype=torch.float64))
    ys, eps = (torch.as_tensor(rng.standard_normal((T, B, d))) for _ in range(2))
    one = [tl.LGSSM(*(z[b] if i < 2 else z[:, b] for i, z in enumerate(lg))) for b in range(B)]
    for parallel in (True, False):
        ms, Ps, ell = filtering(ys, lg, parallel, keep_batch=True)
        xs = sampling(eps, ms, Ps, lg, parallel)
        for b in range(B):
            want = filtering(ys[:, b], one[b], parallel)
            for g, w in zip((ms[:, b], Ps[:, b], ell[b]), want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(
                xs[:, b].numpy(), sampling(eps[:, b], want[0], want[1], one[b], parallel).numpy(),
                rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(filtering(ys, lg, parallel)[2]), float(ell.sum()),
                                   rtol=1e-12)
    per = tl.trajectory_logdensity(ys, xs, lg, keep_batch=True)
    assert per.shape == (B,)
    np.testing.assert_allclose(per.numpy(), [float(tl.trajectory_logdensity(
        ys[:, b], xs[:, b], one[b])) for b in range(B)], rtol=1e-12)
    np.testing.assert_allclose(float(tl.trajectory_logdensity(ys, xs, lg)), float(per.sum()),
                               rtol=1e-12)
