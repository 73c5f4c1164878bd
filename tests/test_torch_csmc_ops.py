"""The port's cSMC ops against the JAX package's: log-space helpers,
resampling from uniforms (multinomial, categorical, systematic with its
degenerate-w_0 guard, `jax.random.choice`'s draw) and the two pair-factor
helpers. Inputs from numpy seeds, float64 on both sides.

Tolerance: the same algebra in other association orders agrees to ~1e-15;
rtol 1e-12 catches any wrong term. Indices must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import csmc_base as jbase  # noqa: E402
from aux_ssm_tpu.ops import logspace as jlog  # noqa: E402
from aux_ssm_tpu.ops import resampling as jres  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc_base as tbase  # noqa: E402
from aux_ssm_tpu_torch.ops import logspace as tlog  # noqa: E402
from aux_ssm_tpu_torch.ops import resampling as tres  # noqa: E402


def _t(z):
    return torch.as_tensor(np.array(z))


def _weights(rng, N, peaked=False):
    lw = rng.standard_normal(N) * (6.0 if peaked else 1.0)
    w = np.exp(lw - lw.max())
    return w / w.sum()


def test_log1mexp_and_logsubexp_match_jax():
    rng = np.random.default_rng(0)
    x = -np.concatenate([rng.exponential(2.0, 50), [1e-12, 0.5, np.log(2.0), 30.0]])
    np.testing.assert_allclose(tlog.log1mexp(_t(x)).numpy(), np.asarray(jlog.log1mexp(x)),
                               rtol=1e-12)
    a, b = rng.standard_normal((2, 40)) * 3
    np.testing.assert_allclose(tlog.logsubexp(_t(a), _t(b)).numpy(),
                               np.asarray(jlog.logsubexp(a, b)), rtol=1e-12)


@pytest.mark.parametrize("dim", [None, 0, 1])
def test_normalize_matches_jax(dim):
    lw = np.random.default_rng(1).standard_normal((5, 7)) * 10
    got = tlog.normalize(_t(lw), dim=dim).numpy()
    np.testing.assert_allclose(got, np.asarray(jlog.normalize(lw, axis=dim)), rtol=1e-12)


@pytest.mark.parametrize("N,peaked", [(8, False), (64, True), (500, False)])
def test_multinomial_and_categorical_from_uniforms_match_jax(N, peaked):
    rng = np.random.default_rng(N)
    w = _weights(rng, N, peaked)
    u = rng.uniform(size=N)
    np.testing.assert_array_equal(tres.multinomial_from_uniforms(_t(u), _t(w)).numpy(),
                                  np.asarray(jres.multinomial_from_uniforms(u, w)))
    for v in rng.uniform(size=20):
        # unnormalised weights: the draw inverts v * total mass
        got = int(tres.categorical_from_uniform(_t(v), _t(3.0 * w)))
        assert got == int(jres.categorical_from_uniform(v, 3.0 * w))


def test_choice_from_uniform_is_jax_random_choice():
    rng = np.random.default_rng(2)
    w = _weights(rng, 30, peaked=True)
    for key in jax.random.split(jax.random.key(0), 25):
        want = int(jax.random.choice(key, 30, p=jnp.asarray(w)))
        u = jax.random.uniform(key, (), jnp.float64)
        assert int(tres.choice_from_uniform(_t(u), _t(w))[0]) == want


@pytest.mark.parametrize("N,w0", [(16, None), (50, 0.3), (9, 0.0), (12, 1.0)])
def test_systematic_from_uniforms_matches_jax(N, w0):
    """w0 = 0 is the degenerate reference weight (underflowed to 0): slot 0
    must still map to index 0; w0 = 1 puts every copy on particle 0."""
    rng = np.random.default_rng(N)
    w = _weights(rng, N)
    if w0 is not None:
        w = np.concatenate([[w0], (1 - w0) * w[1:] / w[1:].sum()])
    for u in rng.uniform(size=(10, 3)):
        got = tres.systematic_from_uniforms(_t(u), _t(w)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jres.systematic_from_uniforms(u, w)))
        assert got[0] == 0


def test_schemes_from_a_generator_pin_index_zero():
    w = torch.as_tensor(_weights(np.random.default_rng(3), 40))
    gen = torch.Generator().manual_seed(0)
    for scheme in (tres.multinomial, tres.systematic):
        idx = scheme(w, gen)
        assert idx.shape == (40,) and int(idx[0]) == 0 and int(idx.max()) < 40
    assert tres.get("systematic") is tres.systematic
    with pytest.raises(ValueError):
        tres.get("stratified")


def _dense(rf, cf, rb, cb):
    """The pair scores rb_i + cb_j + rf_i . cf_j of a set of factors."""
    return (np.asarray(rb)[..., :, None] + np.asarray(cb)[..., None, :]
            + np.einsum("...ik,...jk->...ij", np.asarray(rf), np.asarray(cf)))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_pair_factors_match_jax(batch):
    """The port centres its factors (a shared shift of both sides), so they
    are another gauge of JAX's: the dense scores must agree."""
    rng = np.random.default_rng(4)
    N, d = 6, 3
    mean_prev, x_next = rng.standard_normal((2,) + batch + (N, d))
    sig = rng.uniform(0.5, 2.0, d)
    A = rng.standard_normal((d, d))
    chol = np.linalg.cholesky(A @ A.T + d * np.eye(d))
    for tfn, jfn, p in ((tbase.diag_gaussian_pair_factors, jbase.diag_gaussian_pair_factors, sig),
                        (tbase.chol_gaussian_pair_factors, jbase.chol_gaussian_pair_factors,
                         chol)):
        got = tfn(_t(mean_prev), _t(x_next), _t(p))
        jf = jax.vmap(jfn, in_axes=(0, 0, None)) if batch else jfn
        want = jf(mean_prev, x_next, p)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        dense = _dense(*(g.numpy() for g in got))
        assert dense.shape == batch + (N, N)
        np.testing.assert_allclose(dense, _dense(*want), rtol=1e-12, atol=1e-13)


def test_centred_pair_factors_keep_float32_scores_at_cancelling_magnitudes():
    """|x / sig| ~ 50 at d = 64 (the spatial model's shapes): the uncentred
    factors (JAX's) carry terms of ~1e5 into scores of ~1e2 and lose ~1e-2 in
    float32; the centred ones give the float64 scores within 1e-4."""
    rng = np.random.default_rng(5)
    N, d, sig = 25, 64, np.float32(0.3)
    mean_prev = sig * (50.0 + rng.standard_normal((N, d)))
    x_next = mean_prev + sig * rng.standard_normal((N, d))
    want = _dense(*jbase.diag_gaussian_pair_factors(mean_prev, x_next, np.float64(sig)))
    np.testing.assert_allclose(
        _dense(*(z.numpy() for z in tbase.diag_gaussian_pair_factors(
            _t(mean_prev), _t(x_next), np.float64(sig)))), want, rtol=1e-12, atol=1e-9)
    m32, x32 = mean_prev.astype(np.float32), x_next.astype(np.float32)
    s64 = _dense(*jbase.diag_gaussian_pair_factors(m32.astype(np.float64),
                                                   x32.astype(np.float64), np.float64(sig)))
    centred = _dense(*(z.numpy() for z in tbase.diag_gaussian_pair_factors(_t(m32), _t(x32),
                                                                           sig)))
    plain = _dense(*jbase.diag_gaussian_pair_factors(m32, x32, sig))
    assert centred.dtype == plain.dtype == np.float32
    assert np.abs(s64).max() > 50 and np.abs(s64).max() < 1e3
    err = np.abs(centred - s64).max()
    assert err <= 1e-4, err
    assert np.abs(plain - s64).max() > 1e-3
