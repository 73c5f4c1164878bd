"""The plain versions of the stitching kernels and the blocked draws
(`aux_ssm_tpu_torch/ops/stitching.py`) against the JAX package's
`ops/pallas/stitching.py`, on the CPU.

- `counter_uniform` bit for bit over an edge grid (seeds -1, 0 and the int32
  extremes; pair, block, row and column counters past 2^16).
- `row_lse` and `block_masses` (row-max and per-block-max stabilisers)
  against the XLA twins at rtol 1e-12 in float64 (the same sums in other
  orders), and against the Pallas kernels in interpret mode at 5e-5 in
  float32 (the JAX package's own band between kernel and twin). The twin's
  row-max block masses sum through a matmul whose output type is float32
  whatever the inputs (`preferred_element_type`), so there float64 is held
  to rtol 1e-12 against a NumPy float64 evaluation and to the twin at its
  float32 rounding (5e-8).
- `col_sample` identical to `col_sample_xla` (float64 and float32) and to the
  Pallas kernel in interpret mode, pair offsets included.
- `blocked_col_sample`, `within_block_cols` (with its payload) and
  `joint_rowblock_draws` (with row features and payload) identical given the
  same uniforms.
- `stitch_draws` (the fused draws) identical to `stitch_draws_xla` in float64
  (pair offsets, -inf biases and block masses included) and to the Pallas
  kernel in interpret mode in float32.
- A block whose exponentials underflow gives -inf (or a mass at least 88
  log-units down, as the JAX package pins it), and -inf column biases
  neither poison the blocked draws nor get drawn.
- The wrappers run their plain versions for CPU tensors and count no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops.pallas import stitching as jst  # noqa: E402
from aux_ssm_tpu_torch.ops import cuda as K  # noqa: E402
from aux_ssm_tpu_torch.ops import stitching as tst  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import stitching as KS  # noqa: E402

I32 = np.iinfo(np.int32)


def _t(z):
    return torch.as_tensor(np.array(z))


def _factors(P, n, N, k, seed, dtype=np.float64, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple(z.astype(dtype) for z in (scale * rng.standard_normal((P, n, k)),
                                            scale * rng.standard_normal((P, N, k)),
                                            rng.standard_normal((P, N))))


def _draws_inputs(P, N, k, seed, dtype=np.float64, neg_inf=False):
    """(row_logits, u_rows, Lb, rf, cf, cb) of one level's fused draws, as
    tensors: row_logits = rb + logsumexp(Lb, -1). With `neg_inf`, -inf column
    biases (one 128-block of node 0 entirely) and -inf block masses."""
    rng = np.random.default_rng(seed)
    rf, cf, cb = _factors(P, N, N, k, seed=seed, dtype=dtype, scale=0.3)
    if neg_inf:
        cb[:, [5, 77]] = -np.inf
        cb[0, :128] = -np.inf
    Lb = tst.block_masses(_t(rf), _t(cf), _t(cb))
    if neg_inf:
        Lb[:, 3, -1] = -float("inf")
    rb = _t(rng.standard_normal((P, N)).astype(dtype))
    u = _t(rng.uniform(size=(P, N)).astype(dtype))
    return rb + torch.logsumexp(Lb, -1), u, Lb, _t(rf), _t(cf), _t(cb)


def test_counter_uniform_bitwise_over_the_edge_grid():
    seeds = np.array([-1, 0, 1, 12345, I32.max, I32.min, -7], np.int32)
    pairs = np.array([0, 1, 511, 65535, 65537, 1 << 20, I32.max], np.int32)
    blocks = np.array([0, 3, 31, 70000], np.int32)
    rows = np.array([0, 1, 127, 4095, 1 << 17], np.int32)
    cols = np.array([0, 1, 128, 4095, 70001, I32.max], np.int32)
    grid = np.meshgrid(seeds, pairs, blocks, rows, cols, indexing="ij")
    want = np.asarray(jst.counter_uniform(*(jnp.asarray(g) for g in grid)))
    got = tst.counter_uniform(*(_t(g) for g in grid)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 2.0 ** -24 and got.max() <= 1 - 2.0 ** -24
    # Broadcast scalars (Python ints) as the kernels' counters are.
    np.testing.assert_array_equal(tst.counter_uniform(-1, 5, 2, _t(rows), 9).numpy(),
                                  np.asarray(jst.counter_uniform(jnp.int32(-1), jnp.int32(5),
                                                                 jnp.int32(2), jnp.asarray(rows),
                                                                 jnp.int32(9))))
    want_blk = np.asarray(jst._seed_blk(jnp.asarray(seeds))).astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(tst.seed_blk(_t(seeds)).numpy(), want_blk)


@pytest.mark.parametrize("P,n,N,k", [(3, 5, 5, 4), (2, 130, 130, 1), (4, 25, 25, 30),
                                     (2, 64, 256, 9)])
def test_row_lse_matches_xla_twin_f64(P, n, N, k):
    rf, cf, cb = _factors(P, N, N, k, seed=N + k)
    got = tst.row_lse(_t(rf), _t(cf), _t(cb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jst.row_lse_xla(rf, cf, cb, block=64)),
                               rtol=1e-12, atol=1e-12)
    got = KS.row_lse(_t(rf), _t(cf), _t(cb)).numpy()  # the wrapper, on a CPU tensor
    np.testing.assert_allclose(got, np.asarray(jst.row_lse_xla(rf, cf, cb)), rtol=1e-12)


def test_row_lse_matches_pallas_interpret_f32():
    rf, cf, cb = _factors(2, 256, 256, 4, seed=3, dtype=np.float32)
    got = tst.row_lse(_t(rf), _t(cf), _t(cb)).numpy()
    want = np.asarray(jst.row_lse(jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(cb),
                                  interpret=True))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_row_lse_all_neg_inf_row_is_nan_as_the_twin():
    rf, cf, cb = _factors(1, 8, 8, 2, seed=1)
    cb[:] = -np.inf
    got = tst.row_lse(_t(rf), _t(cf), _t(cb)).numpy()
    assert np.isnan(got).all() and np.isnan(np.asarray(jst.row_lse_xla(rf, cf, cb))).all()


@pytest.mark.parametrize("per_block_max", [False, True])
@pytest.mark.parametrize("P,Nr,Nc,k", [(2, 128, 128, 3), (3, 200, 256, 1), (2, 64, 384, 8)])
def test_block_masses_matches_xla_twin_f64(P, Nr, Nc, k, per_block_max):
    rf, cf, cb = _factors(P, Nr, Nc, k, seed=Nr + k)
    got = tst.block_masses(_t(rf), _t(cf), _t(cb), per_block_max).numpy()
    twin = np.asarray(jst.block_masses_xla(rf, cf, cb, per_block_max=per_block_max))
    s = (np.einsum("pik,pjk->pij", rf, cf) + cb[:, None, :]).reshape(P, Nr, Nc // 128, 128)
    m = s.max(-1, keepdims=True) if per_block_max else s.max((-2, -1), keepdims=True)
    dense = np.log(np.exp(s - m).sum(-1)) + m[..., 0]
    want = twin if per_block_max else dense
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, twin, rtol=1e-12 if per_block_max else 5e-8, atol=1e-12)
    np.testing.assert_allclose(
        KS.block_masses(_t(rf), _t(cf), _t(cb), per_block_max=per_block_max).numpy(), want,
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("per_block_max", [False, True])
def test_block_masses_matches_pallas_interpret_f32(per_block_max):
    rf, cf, cb = _factors(2, 256, 256, 2, seed=9, dtype=np.float32)
    got = tst.block_masses(_t(rf), _t(cf), _t(cb), per_block_max).numpy()
    want = np.asarray(jst.block_masses(jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(cb),
                                       per_block_max=per_block_max, interpret=True))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_block_masses_suppressed_block():
    """Every column of block 1 is `gap` log-units under the row max. At 87
    the float32 exponentials are normal: finite and matching the twin. At 95
    they are subnormal: the twin (matmul) flushes them to -inf, the plain
    version (like the kernel where subnormals survive) keeps a mass <= -88;
    either carries probability 0. In float64 a block whose exponentials
    underflow to 0 is exactly -inf."""
    N = 256
    rf = np.ones((1, N, 1), np.float32)
    cf = np.zeros((1, N, 1), np.float32)
    for gap in (87.0, 95.0):
        cb = np.concatenate([np.zeros((1, 128)), np.full((1, 128), -gap)], 1).astype(np.float32)
        got = tst.block_masses(_t(rf), _t(cf), _t(cb)).numpy()
        want = np.asarray(jst.block_masses_xla(rf, cf, cb))
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=5e-5)
        if gap == 87.0:
            np.testing.assert_allclose(got, want, rtol=5e-5)
        else:
            assert (want[..., 1] == -np.inf).all() and (got[..., 1] <= -88.0).all()
    cb = np.concatenate([np.zeros((1, 128)), np.full((1, 128), -800.0)], 1)
    got = tst.block_masses(_t(rf.astype(np.float64)), _t(cf.astype(np.float64)), _t(cb))
    assert (got[..., 1] == -np.inf).all() and torch.isfinite(got[..., 0]).all()
    rows, blocks = tst.joint_rowblock_draws(torch.rand(1, 64, generator=torch.Generator()
                                                       .manual_seed(0), dtype=torch.float64),
                                            torch.zeros(1, N, dtype=torch.float64), got)
    assert (blocks == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("P,n,N,k,seed,offset", [(3, 25, 25, 30, 1234, 0), (2, 300, 64, 2, -1, 0),
                                                 (2, 128, 256, 3, I32.max, 7),
                                                 (5, 9, 25, 64, 77, 100000)])
def test_col_sample_matches_xla_twin(dtype, P, n, N, k, seed, offset):
    rf, cf, cb = _factors(P, n, N, k, seed=n + k, dtype=dtype, scale=0.3)
    want = np.asarray(jst.col_sample_xla(jnp.int32(seed), rf, cf, cb, offset))
    got = tst.col_sample(seed, _t(rf), _t(cf), _t(cb), offset).numpy()
    np.testing.assert_array_equal(got, want)
    got = KS.col_sample(_t(np.int32(seed)), _t(rf), _t(cf), _t(cb), pair_offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_col_sample_matches_pallas_interpret():
    rf, cf, cb = _factors(2, 128, 256, 3, seed=4, dtype=np.float32)
    seed = jnp.int32(1234)
    want = np.asarray(jst.col_sample(seed, jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(cb),
                                     pair_offset=3, interpret=True))
    got = tst.col_sample(1234, _t(rf), _t(cf), _t(cb), pair_offset=3).numpy()
    np.testing.assert_array_equal(got, want)


def test_col_sample_law():
    """Gumbel-argmax frequencies against softmax(rf . cf + cb), over seeds."""
    rf, cf, cb = _factors(1, 1, 8, 2, seed=5)
    s = (rf[0] @ cf[0].T + cb[0])[0]
    p = np.exp(s - s.max())
    p /= p.sum()
    idx = np.array([int(tst.col_sample(sd, _t(rf), _t(cf), _t(cb))[0, 0]) for sd in range(4000)])
    np.testing.assert_allclose(np.bincount(idx, minlength=8) / 4000, p, atol=4 * 0.008)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_blocked_draws_match_jax_given_the_same_uniforms(dtype):
    P, N, k, e = 3, 256, 2, 2
    rng = np.random.default_rng(11)
    rf, cf, cb = _factors(P, N, N, k, seed=12, dtype=dtype, scale=0.3)
    rb = rng.standard_normal((P, N)).astype(dtype)
    extra_r, extra_c = (rng.standard_normal((P, N, e)).astype(dtype) for _ in range(2))
    u = rng.uniform(size=(P, N)).astype(dtype)
    Lb = np.asarray(jst.block_masses_xla(rf, cf, cb))
    np.testing.assert_allclose(tst.block_masses(_t(rf), _t(cf), _t(cb)).numpy(), Lb,
                               rtol=1e-12 if dtype == np.float64 else 2e-5, atol=1e-6)

    j = jst.joint_rowblock_draws(jnp.asarray(u), jnp.asarray(rb), jnp.asarray(Lb),
                                 row_feat=jnp.asarray(rf), row_extra=jnp.asarray(extra_r))
    t = tst.joint_rowblock_draws(_t(u), _t(rb), _t(Lb), row_feat=_t(rf), row_extra=_t(extra_r))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows_t, blocks_t = tst.joint_rowblock_draws(_t(u), _t(rb), _t(Lb))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(blocks_t.numpy(), np.asarray(j[1]))

    rows, blocks, rf_sel = (np.asarray(z) for z in j[:3])
    jc, jex = jst.within_block_cols(jnp.int32(-5), jnp.asarray(blocks), jnp.asarray(rf_sel),
                                    jnp.asarray(cf), jnp.asarray(cb), pair_offset=2,
                                    col_extra=jnp.asarray(extra_c))
    tc, tex = tst.within_block_cols(-5, _t(blocks), _t(rf_sel), _t(cf), _t(cb), pair_offset=2,
                                    col_extra=_t(extra_c))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jex))
    assert (tc.numpy() // 128 == blocks).all()

    jb = jst.blocked_col_sample(jnp.int32(9), jnp.asarray(rows), jnp.asarray(Lb),
                                jnp.asarray(rf_sel), jnp.asarray(cf), jnp.asarray(cb), 4)
    tb = tst.blocked_col_sample(9, _t(rows), _t(Lb), _t(rf_sel), _t(cf), _t(cb), 4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_within_block_cols_in_pair_chunks(monkeypatch):
    """Chunking the pairs (to bound memory) changes no draw, of
    within_block_cols or of stitch_draws."""
    P, N, k = 5, 256, 1
    rf, cf, cb = _factors(P, N, N, k, seed=13)
    blocks = _t(np.random.default_rng(0).integers(0, 2, (P, N)))
    whole = tst.within_block_cols(3, blocks, _t(rf), _t(cf), _t(cb))
    draws = _draws_inputs(P, N, k, seed=13)
    fused = tst.stitch_draws(3, *draws, pair_offset=2)
    monkeypatch.setattr(tst, "_CHUNK", 2 * N * 128)
    np.testing.assert_array_equal(tst.within_block_cols(3, blocks, _t(rf), _t(cf), _t(cb)).numpy(),
                                  whole.numpy())
    for a, b in zip(tst.stitch_draws(3, *draws, pair_offset=2), fused):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    monkeypatch.setattr(tst, "_CHUNK", 3 * N)  # row chunks of the score passes
    np.testing.assert_allclose(tst.row_lse(_t(rf), _t(cf), _t(cb)).numpy(),
                               np.asarray(jst.row_lse_xla(rf, cf, cb)), rtol=1e-12)


def test_blocked_paths_tolerate_neg_inf_biases():
    """-inf column biases (zero weights, indicator potentials) on scattered
    columns and on a whole 128-block: Lb holds -inf for the empty block, the
    draws stay finite, no dead column is drawn, and the port's draws equal
    JAX's."""
    rng = np.random.default_rng(77)
    N, k, n = 256, 2, 64
    rf = (0.3 * rng.standard_normal((1, N, k))).astype(np.float32)
    cf = (0.3 * rng.standard_normal((1, N, k))).astype(np.float32)
    cb = rng.standard_normal((1, N)).astype(np.float32)
    dead = np.zeros(N, bool)
    dead[[5, 17, 99]] = True
    dead[128:] = True
    cb[0, dead] = -np.inf
    rb = rng.standard_normal((1, N)).astype(np.float32)
    Lb = tst.block_masses(_t(rf), _t(cf), _t(cb))
    assert bool(torch.isinf(Lb[0, 0, 1]))
    u = rng.uniform(size=(1, n)).astype(np.float32)
    rows, blocks, rf_sel = tst.joint_rowblock_draws(_t(u), _t(rb), Lb, row_feat=_t(rf))
    cols = tst.within_block_cols(3, blocks, rf_sel, _t(cf), _t(cb))
    assert (blocks == 0).all() and not dead[cols.numpy().ravel()].any()
    jcols = jst.within_block_cols(jnp.int32(3), jnp.asarray(blocks.numpy()),
                                  jnp.asarray(rf_sel.numpy()), jnp.asarray(cf), jnp.asarray(cb))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    rows_u = _t(rng.integers(0, N, (1, n)))
    cols_b = tst.blocked_col_sample(5, rows_u, Lb, _t(rf)[0][rows_u], _t(cf), _t(cb))
    assert not dead[cols_b.numpy().ravel()].any()
    assert torch.isfinite(tst.row_lse(_t(rf), _t(cf), _t(cb))).all()


def test_wrappers_run_plain_on_the_cpu_and_count_no_launch():
    rf, cf, cb = (_t(z) for z in _factors(2, 128, 128, 2, seed=2))
    K.reset_launches()
    KS.row_lse(rf, cf, cb)
    KS.col_sample(1, rf, cf, cb)
    KS.block_masses(rf, cf, cb)
    blocks = torch.zeros(2, 128, dtype=torch.int64)
    np.testing.assert_array_equal(KS.within_block_cols(1, blocks, rf, cf, cb).numpy(),
                                  tst.within_block_cols(1, blocks, rf, cf, cb).numpy())
    draws = _draws_inputs(2, 128, 2, seed=2)
    for a, b in zip(KS.stitch_draws(4, *draws, pair_offset=1),
                    tst.stitch_draws(4, *draws, pair_offset=1)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    names = ("row_lse", "col_sample", "block_masses", "within_block_cols", "stitch_draws")
    assert {n: K.launches()[n] for n in names} == dict.fromkeys(names, 0)
    with pytest.raises(ValueError, match="multiple of 128"):
        KS.stitch_draws(4, *(z[:, :100] for z in draws[:2]), draws[2][:, :100],
                        *(z[:, :100] for z in draws[3:]))
    with pytest.raises(ValueError, match="do not match"):
        KS.stitch_draws(4, draws[0], draws[1], draws[2][..., :0], *draws[3:])
    with pytest.raises(ValueError, match="multiple of 128"):
        KS.block_masses(rf[:, :, :], cf[:, :100], cb[:, :100])
    with pytest.raises(ValueError, match="do not match"):
        KS.row_lse(rf, cf[:, :, :1], cb)


@pytest.mark.parametrize("P,N,k,offset,neg_inf", [
    (2, 256, 2, 0, False), (2, 256, 2, 3, False), (1, 128, 1, 0, False), (1, 128, 1, 3, False),
    (3, 512, 3, 0, False), (3, 512, 3, 3, False), (2, 256, 2, 3, True)])
def test_stitch_draws_matches_xla_twin_f64(P, N, k, offset, neg_inf):
    """The fused draws given the same seed and uniforms: rows and columns
    identical to `stitch_draws_xla` (which takes its tile sums from a
    float32-output matmul: a draw could flip only where a uniform falls
    within 1e-7 of a CDF step, and none does here)."""
    draws = _draws_inputs(P, N, k, seed=N + k + offset, neg_inf=neg_inf)
    want = jst.stitch_draws_xla(jnp.int32(-77), *(jnp.asarray(z.numpy()) for z in draws),
                                pair_offset=offset)
    got = tst.stitch_draws(-77, *draws, pair_offset=offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows, cols = (g.numpy() for g in got)
    assert len(np.unique(rows)) > 1 and len(np.unique(cols)) > 1
    assert N == 128 or len(np.unique(cols // 128)) > 1  # more than one block drawn
    if neg_inf:  # no dead column is drawn
        assert np.isfinite(draws[-1].numpy()[np.arange(P)[:, None], cols]).all()


def test_stitch_draws_matches_pallas_interpret_f32():
    draws = _draws_inputs(2, 256, 2, seed=21, dtype=np.float32)
    want = jst.stitch_draws(jnp.int32(1234), *(jnp.asarray(z.numpy()) for z in draws),
                            pair_offset=3, interpret=True)
    got = tst.stitch_draws(1234, *draws, pair_offset=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
