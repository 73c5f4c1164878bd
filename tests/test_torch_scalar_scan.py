"""The port's scalar scans (`aux_ssm_tpu_torch/ops/cuda/scalar_scan.py`, the
plain versions in the CUDA kernel's chunk order) against the JAX package's:

- float64 against `jax.lax.associative_scan` of `filtering_operator` /
  `sampling_operator` on the (n, B, 1, 1) layout: the same combines in another
  association order, agreeing to ~1e-13; rtol 1e-10 catches any wrong term;
- float32 against the Pallas kernels in interpret mode (both schedules, the
  block Hillis-Steele below T = 512 and the chunked one), at the JAX
  package's own kernel-vs-XLA bound rtol = atol = 2e-5.
Shapes are those of `tests/test_scalar_scan.py`, plus n = 1 and B = 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops.filtering import filtering_operator  # noqa: E402
from aux_ssm_tpu.ops.pallas import scalar_scan as jss  # noqa: E402
from aux_ssm_tpu.ops.sampling import sampling_operator  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS  # noqa: E402

SHAPES = [(64, 16), (100, 36), (513, 130), (1024, 64), (1, 5), (37, 1)]


def _filter_elems(rng, n, B, dtype):
    return tuple(z.astype(dtype) for z in (
        rng.uniform(0.5, 1.0, (n, B)), rng.standard_normal((n, B)), rng.uniform(0.1, 1.0, (n, B)),
        rng.standard_normal((n, B)), rng.uniform(0.0, 0.5, (n, B))))


def _affine_elems(rng, n, B, dtype):
    return (rng.uniform(-0.9, 0.9, (n, B)).astype(dtype),
            rng.standard_normal((n, B)).astype(dtype))


def _as_mat(elems):
    A, b, C, e, J = (jnp.asarray(z) for z in elems)
    return A[..., None, None], b[..., None], C[..., None, None], e[..., None], J[..., None, None]


def _t(elems):
    return tuple(torch.as_tensor(z) for z in elems)


@pytest.mark.parametrize("n,B", SHAPES)
def test_filter_scan_matches_associative_scan_f64(n, B):
    elems = _filter_elems(np.random.default_rng(n + B), n, B, np.float64)
    want = jax.lax.associative_scan(filtering_operator, _as_mat(elems))
    got = SS.scalar_filter_scan(_t(elems))  # CPU tensors: the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == (n, B)
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(n, B), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n,B", SHAPES)
def test_affine_scan_matches_associative_scan_f64(n, B, reverse):
    g, e = _affine_elems(np.random.default_rng(3 * n + B), n, B, np.float64)
    rg, re = jax.lax.associative_scan(
        sampling_operator, (jnp.asarray(g)[..., None, None], jnp.asarray(e)[..., None]),
        reverse=reverse)
    og, oe = SS.scalar_affine_scan(torch.as_tensor(g), torch.as_tensor(e), reverse=reverse)
    np.testing.assert_allclose(og.numpy(), np.asarray(rg)[..., 0, 0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(oe.numpy(), np.asarray(re)[..., 0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,B", [(64, 16), (100, 36), (513, 130), (1024, 64)])
def test_filter_scan_matches_pallas_interpret_f32(n, B):
    elems = _filter_elems(np.random.default_rng(n + B), n, B, np.float32)
    got = SS.scalar_filter_scan_plain(_t(elems))
    jelems = tuple(jnp.asarray(z) for z in elems)
    for want in (jss.fused_scalar_filter_scan(jelems, interpret=True),
                 jss._chunked_block_scan(list(jelems), jss._filter_combine, jss._FILTER_IDENT,
                                         interpret=True)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n,B", [(64, 16), (100, 36), (513, 130)])
def test_affine_scan_matches_pallas_interpret_f32(n, B, reverse):
    g, e = _affine_elems(np.random.default_rng(3 * n + B), n, B, np.float32)
    og, oe = SS.scalar_affine_scan_plain(torch.as_tensor(g), torch.as_tensor(e), reverse=reverse)
    wg, we = jss.fused_scalar_affine_scan(jnp.asarray(g), jnp.asarray(e), reverse=reverse,
                                          interpret=True)
    np.testing.assert_allclose(og.numpy(), np.asarray(wg), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(oe.numpy(), np.asarray(we), rtol=2e-5, atol=2e-5)


def test_combines_match_the_matrix_operators():
    rng = np.random.default_rng(0)
    e1, e2 = (_filter_elems(rng, 17, 5, np.float64) for _ in range(2))
    want = filtering_operator(_as_mat(e1), _as_mat(e2))
    for g, w in zip(SS.filter_combine(_t(e1), _t(e2)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(17, 5), rtol=1e-13)
    a1, a2 = (_affine_elems(rng, 17, 5, np.float64) for _ in range(2))
    wg, we = sampling_operator((jnp.asarray(a1[0])[..., None, None], jnp.asarray(a1[1])[..., None]),
                               (jnp.asarray(a2[0])[..., None, None], jnp.asarray(a2[1])[..., None]))
    g, e = SS.affine_combine(_t(a1), _t(a2))
    np.testing.assert_allclose(g.numpy(), np.asarray(wg)[..., 0, 0], rtol=1e-13)
    np.testing.assert_allclose(e.numpy(), np.asarray(we)[..., 0], rtol=1e-13)


def test_wrappers_dispatch_by_device_only(monkeypatch):
    """A CPU tensor takes the plain path whatever the environment says; a
    tensor on the card goes to the kernel's launch (mocked here: no card)."""
    monkeypatch.setenv("AUX_SSM_SCALAR_SCAN", "hs")
    monkeypatch.setenv("AUX_SSM_PALLAS", "0")
    elems = _t(_filter_elems(np.random.default_rng(1), 20, 3, np.float64))
    before = SS.scalar_filter_scan.launches, SS.scalar_affine_scan.launches
    for g, w in zip(SS.scalar_filter_scan(elems), SS.scalar_filter_scan_plain(elems)):
        assert torch.equal(g, w)
    assert torch.equal(SS.scalar_affine_scan(elems[0], elems[1], reverse=True)[1],
                       SS.scalar_affine_scan_plain(elems[0], elems[1], reverse=True)[1])
    assert (SS.scalar_filter_scan.launches, SS.scalar_affine_scan.launches) == before

    launched = []
    monkeypatch.setattr(SS, "_on_cuda", lambda name, ref: True)
    monkeypatch.setattr(SS, "launch", lambda name, dtype, *args: launched.append((name, args[:3])))
    SS.scalar_filter_scan(elems)
    SS.scalar_affine_scan(elems[0], elems[1], reverse=True)
    assert [name for name, _ in launched] == ["scalar_filter_scan", "scalar_affine_scan"]
    assert launched[0][1][:2] == (20, 3) and launched[1][1] == (20, 3, 1)
    assert (SS.scalar_filter_scan.launches, SS.scalar_affine_scan.launches) == (
        before[0] + 1, before[1] + 1)
    SS.scalar_filter_scan.launches, SS.scalar_affine_scan.launches = before


def test_wrappers_reject_mismatched_shapes():
    elems = list(_t(_filter_elems(np.random.default_rng(2), 8, 3, np.float64)))
    elems[2] = elems[2][:, :2]
    with pytest.raises(ValueError, match="argument 2"):
        SS.scalar_filter_scan(elems)
    with pytest.raises(ValueError, match=r"\(n, B\)"):
        SS.scalar_affine_scan(elems[0][0], elems[1][0])
