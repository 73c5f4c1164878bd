"""The port's divide-and-conquer bridge sampler
(`aux_ssm_tpu_torch/ops/dnc_sampling.py`) against the JAX package's
`ops/dnc_sampling.py` on filtered random LGSSMs: the leaf maps, the
composition and the whole tree (T = 8 transitions, and T = 9, whose levels
carry an odd segment up; dx = 1, the scalar branches, and dx = 3), and a
draw given the normals JAX's key splits produce (T = 9, dx = 3: the odd
segment; each JAX draw costs seconds of eager dispatch).

Tolerance: float64 on both sides; maps and tree rtol 1e-12 (the same
algebra, Cholesky solves on both sides), the draw rtol 1e-9.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.ops import dnc_sampling as jdnc  # noqa: E402
from aux_ssm_tpu.ops.lgssm import LGSSM as JLGSSM  # noqa: E402
from aux_ssm_tpu_torch.ops import LGSSM, dnc_sampling, filtering  # noqa: E402
from oracles import random_lgssm, simulate  # noqa: E402

CASES = [(8, 1), (8, 3), (9, 1), (9, 3)]   # (transitions, dx)


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-13)


_MODELS = {}


def _model(T, dx):
    """(ms, Ps, JAX LGSSM, port LGSSM): T + 1 filtered moments of a random
    model with dy = 2 (by the port's filter: they are inputs to both)."""
    if (T, dx) not in _MODELS:
        rng = np.random.default_rng(10 * T + dx)
        params = random_lgssm(rng, T + 1, dx, 2)
        tl = LGSSM(*(torch.as_tensor(p) for p in params))
        ms, Ps, _ = filtering(torch.as_tensor(simulate(rng, *params)), tl, False)
        _MODELS[T, dx] = (ms.numpy(), Ps.numpy(), JLGSSM(*map(jnp.asarray, params)), tl)
    return _MODELS[T, dx]


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


@pytest.mark.parametrize("T, dx", CASES)
def test_leaf_maps_and_compose_match_jax(T, dx):
    ms, Ps, jl, _ = _model(T, dx)
    args = (ms[:-1], Ps[:-1], jl.Fs, jl.Qs, jl.bs)
    want = jdnc._leaf_maps(*args)
    got = dnc_sampling._leaf_maps(*_t(*args))
    for g, w in zip(got, want):
        _close(g, w)
    left, right = tuple(z[0:-1:2] for z in want), tuple(z[1::2] for z in want)
    n = min(len(left[0]), len(right[0]))
    left, right = tuple(z[:n] for z in left), tuple(z[:n] for z in right)
    for g, w in zip(dnc_sampling._compose(*_t(*left), *_t(*right)), jdnc._compose(*left, *right)):
        _close(g, w)


@pytest.mark.parametrize("T, dx", CASES)
def test_tree_matches_jax(T, dx):
    ms, Ps, jl, tl = _model(T, dx)
    j_root, j_bridges, *j_idx = jdnc._build_tree(jnp.asarray(ms), jnp.asarray(Ps), jl)
    t_root, t_bridges, *t_idx = dnc_sampling._build_tree(*_t(ms, Ps), tl)
    for g, w in zip(t_root, j_root):
        _close(g, w)
    assert len(t_bridges) == len(j_bridges)
    for tb, jb in zip(t_bridges, j_bridges):
        for g, w in zip(tb, jb):
            _close(g, w)
    for t_list, j_list in zip(t_idx, j_idx):
        for a, b in zip(t_list, j_list):
            np.testing.assert_array_equal(a, b)


def _jax_normals(key, dx, level_sizes):
    """The normals JAX's `sampling` draws from `key`, in its order: x_T's,
    x_0's, then each level's midpoints root-down."""
    key, key_0, key_T = jax.random.split(key, 3)
    rows = [jax.random.normal(key_T, (dx,), jnp.float64),
            jax.random.normal(key_0, (dx,), jnp.float64)]
    for n in level_sizes:
        key, subkey = jax.random.split(key)
        rows.extend(jax.vmap(lambda k: jax.random.normal(k, (dx,), jnp.float64))(
            jax.random.split(subkey, n)))
    return np.stack([np.asarray(r) for r in rows])


@pytest.mark.parametrize("T, dx", [(9, 3)])
def test_sampling_given_jax_normals_matches_jax(T, dx):
    ms, Ps, jl, tl = _model(T, dx)
    key = jax.random.key(T + dx)
    mids = dnc_sampling._build_tree(*_t(ms, Ps), tl)[3]
    noise = _jax_normals(key, dx, [len(m) for m in mids])
    assert noise.shape == (T + 1, dx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = jdnc.sampling(key, jnp.asarray(ms), jnp.asarray(Ps), jl)
        got = dnc_sampling.sampling(*_t(ms, Ps), tl, noise=torch.as_tensor(noise))
    _close(got, want, rtol=1e-9)
    # Drawn from a generator instead, the trajectory is finite and ends where
    # the filter does, in law.
    with pytest.warns(UserWarning, match="proof-of-concept"):
        xs = dnc_sampling.sampling(*_t(ms, Ps), tl, generator=torch.Generator().manual_seed(0))
    assert xs.shape == (T + 1, dx) and bool(torch.isfinite(xs).all())


def test_rejects_batched_input():
    z = torch.zeros(4, 3, 2)
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="Batched"):
        dnc_sampling.sampling(z, torch.zeros(4, 3, 2, 2), LGSSM(*[torch.zeros(())] * 8))
