"""The plain versions of the port's kernels against the JAX package's Pallas
kernels run in interpret mode, given the same float64 inputs.

Tolerance: both sides are float64 and compute the same algebra, with other
summation orders and solvers (LAPACK on the torch side, substitution in the
Pallas kernels) and, for the scans, other association orders; they agree to
~1e-12, and rtol 1e-9 still fails on any wrong term. The backward maps take
the jittered Cholesky of a nearly singular covariance, which amplifies
rounding: there the band is the JAX suite's own (rtol 1e-7).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops.pallas.filter_scan import _fused_filter_scan_chunked  # noqa: E402
from aux_ssm_tpu.ops.pallas.kalman_fused import (  # noqa: E402
    fused_affine_scan, fused_backward_maps, fused_ell, fused_logdensity_steps,
    fused_make_elements)
from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF  # noqa: E402

JF = importlib.import_module("aux_ssm_tpu.ops.filtering")


def _model(T, dx, dy, seed, nan_frac=0.0):
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = random_lgssm(rng, T, dx, dy)
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    return params, ys


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def _close(got, want, rtol=1e-9, atol=1e-11):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _filter_inputs(T, dx, dy, seed, nan_frac):
    """Step inputs (F, Q, b, H, R, c, y) for t >= 1 and the JAX-updated t=0 state."""
    (m0, P0, Fs, Qs, bs, Hs, Rs, cs), ys = _model(T, dx, dy, seed, nan_frac)
    m0u, P0u, _ = JF.kalman_update(*map(jnp.asarray, (ys[0], m0, P0, Hs[0], cs[0], Rs[0])))
    steps = (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:])
    return steps, np.asarray(m0u), np.asarray(P0u)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(23, 2, 2, 0.0), (64, 4, 3, 0.3),
                                              (140, 3, 1, 0.0)])
def test_make_elements_and_ell_match_pallas(T, dx, dy, nan_frac):
    steps, m0u, P0u = _filter_inputs(T, dx, dy, seed=0, nan_frac=nan_frac)
    m = np.concatenate([m0u[None], np.zeros((T - 2, dx))])
    P = np.concatenate([P0u[None], np.zeros((T - 2, dx, dx))])
    want = fused_make_elements(*map(jnp.asarray, steps + (m, P)), interpret=True)
    got = KF.make_elements_plain(*_t(*steps, m, P))
    _close(got, want)

    _, ms, Ps, _, _ = jax.lax.associative_scan(JF.filtering_operator, want)
    ms = np.concatenate([m0u[None], np.asarray(ms)])[:-1]
    Ps = np.concatenate([P0u[None], np.asarray(Ps)])[:-1]
    want = fused_ell(*map(jnp.asarray, steps + (ms, Ps)), interpret=True)
    _close([KF.ell_plain(*_t(*steps, ms, Ps))], [want])


@pytest.mark.parametrize("T,dx", [(40, 2), (100, 4)])
def test_backward_maps_match_pallas(T, dx):
    (m0, P0, Fs, Qs, bs, Hs, Rs, cs), ys = _model(T, dx, 2, seed=5)
    from aux_ssm_tpu.ops.lgssm import LGSSM
    ms, Ps, _ = JF.filtering(jnp.asarray(ys), LGSSM(*map(jnp.asarray, (
        m0, P0, Fs, Qs, bs, Hs, Rs, cs))), False)
    eps = np.random.default_rng(6).standard_normal((T - 1, dx))
    args = (Fs, Qs, bs, np.asarray(ms)[:-1], np.asarray(Ps)[:-1], eps)
    want = fused_backward_maps(*map(jnp.asarray, args), interpret=True)
    _close(KF.backward_maps_plain(*_t(*args)), want, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(30, 2, 2, 0.0), (70, 3, 2, 0.4)])
def test_logdensity_steps_match_pallas(T, dx, dy, nan_frac):
    (m0, P0, Fs, Qs, bs, Hs, Rs, cs), ys = _model(T, dx, dy, seed=2, nan_frac=nan_frac)
    xs = np.random.default_rng(3).standard_normal((T, dx))
    args = (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], xs[:-1], xs[1:])
    want = fused_logdensity_steps(*map(jnp.asarray, args), interpret=True)
    _close([KF.logdensity_steps_plain(*_t(*args))], [want])


@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (256, 2, True), (100, 4, False)])
def test_affine_scan_matches_pallas(T, d, reverse):
    rng = np.random.default_rng(1)
    gains = 0.4 * rng.standard_normal((T, d, d))
    incs = rng.standard_normal((T, d))
    want = fused_affine_scan(jnp.asarray(gains), jnp.asarray(incs), reverse=reverse,
                             interpret=True)
    _close(FS.affine_scan_plain(*_t(gains, incs), reverse=reverse), want)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(17, 2, 2, 0.0), (129, 3, 1, 0.0),
                                              (300, 3, 2, 0.2)])
def test_filter_scan_matches_pallas_chunked(T, dx, dy, nan_frac):
    steps, m0u, P0u = _filter_inputs(T, dx, dy, seed=0, nan_frac=nan_frac)
    elems = JF._make_associative_elements(*map(jnp.asarray, steps), jnp.asarray(m0u),
                                          jnp.asarray(P0u))
    want = _fused_filter_scan_chunked(elems, interpret=True)
    _close(FS.filter_scan_plain(_t(*elems)), want)
