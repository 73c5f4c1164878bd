"""The port's sharded kernels (`aux_ssm_tpu_torch/kernels/{csmc_sharded,
pit_sharded}.py`) on shards of "cpu", against the port's one-device kernels
bit for bit, and against the JAX package's sharded kernels on its 8 virtual
CPU devices given JAX's noise.

- Particle-sharded cSMC (S = 4, N = 16, T = 10, d = 2, a bootstrap filter of
  an AR(1) model: the generic step loop), ancestor scanning and backward
  sampling, multinomial and systematic: x and `updated` identical to the
  one-device generic loop's over three chained steps; a one-shard mesh is
  `csmc.get_kernel` itself; N not divisible raises.
- Particle-sharded PIT at (S, N, T) = (4, 512, 8) and (2, 256, 12), both
  draws: identical to `pit.get_kernel(stitch="blocked", block_max="block")`;
  its shape checks raise.
- Time-sharded PIT at (C, Tc, N) = (8, 4, 16), (3, 8, 16), (6, 4, 8), a
  generic and a pair-factorising Gt: identical x and `updated`; a one-shard
  mesh is `pit.get_kernel`; C not dividing T, or T/C not a power of two,
  raises.
- Against JAX, float64: one time-sharded step (8 devices, T = 16, N = 16)
  and one particle-sharded step (2 devices, N = 256, T = 8), factorising Gt,
  given the noise JAX draws from its key: identical picked indices
  (`updated`) and x to rtol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import csmc_independent as jind  # noqa: E402
from aux_ssm_tpu.kernels import pit_sharded as jps  # noqa: E402
from aux_ssm_tpu.parallel import mesh as jmesh  # noqa: E402
from aux_ssm_tpu.parallel.time_scan import TIME as JTIME  # noqa: E402
from aux_ssm_tpu_torch.experiments import multichip as mc  # noqa: E402
from aux_ssm_tpu_torch.kernels import csmc, csmc_sharded, pit, pit_sharded  # noqa: E402
from aux_ssm_tpu_torch.parallel.mesh import PARTICLES, make_mesh  # noqa: E402
from aux_ssm_tpu_torch.parallel.time_scan import TIME  # noqa: E402
from test_pit_sharded import G0 as JG0, FactorGt as JFactorGt  # noqa: E402
from test_torch_pit import jax_tree_noise  # noqa: E402

f64 = torch.float64


def cpu_mesh(S, axis):
    return make_mesh(devices=["cpu"] * S, axis_names=(axis,))


def _same(a, b):
    assert torch.equal(a.updated, b.updated) and torch.equal(a.x, b.x)


# --------------------------------------------------------------------------
# Particle-sharded cSMC
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("resampling", ["multinomial", "systematic"])
def test_sharded_csmc_equals_the_generic_loop(backward, resampling):
    T, N, d = 10, 16, 2
    g = torch.Generator().manual_seed(backward + 2 * (resampling == "systematic"))
    parts = (mc.Prior(), mc.Prior(), mc.AR(), mc.ObsOnly(params=torch.randn(T - 1, d, generator=g,
                                                                           dtype=f64)))
    one = csmc.get_kernel(*parts, N, backward=backward, resampling=resampling)
    shard = csmc_sharded.get_sharded_kernel(*parts, N, cpu_mesh(4, PARTICLES),
                                            backward=backward, resampling=resampling)
    x, moved = torch.randn(T, d, generator=g, dtype=f64), 0
    for _ in range(3):
        noise = csmc.draw_noise(x, N, csmc.resampling_mod.get(resampling), g)
        a, b = one[1](one[0](x), noise=noise), shard[1](shard[0](x), noise=noise)
        _same(b, a)
        moved += int(a.updated.sum())
        x = a.x
    assert moved > 0


def test_sharded_csmc_one_shard_and_shape_checks():
    parts = (mc.Prior(), mc.Prior(), mc.AR(), mc.ObsOnly(params=torch.zeros(3, 1)))
    _, kernel = csmc_sharded.get_sharded_kernel(*parts, 8, cpu_mesh(1, PARTICLES))
    assert kernel.__qualname__ == csmc.get_kernel(*parts, 8)[1].__qualname__
    with pytest.raises(ValueError, match="not divisible"):
        csmc_sharded.get_sharded_kernel(*parts, 10, cpu_mesh(4, PARTICLES))
    init, kernel = csmc_sharded.get_sharded_kernel(*parts, 8, cpu_mesh(2, PARTICLES))
    with pytest.raises(ValueError, match="one chain"):
        kernel(init(torch.zeros(2, 4, 1)))


# --------------------------------------------------------------------------
# Particle- and time-sharded PIT
# --------------------------------------------------------------------------

def _steps(one, shard, T, N, seed, n=2):
    """n chained steps of both kernels on the same noise; the count of moved
    indices."""
    g = torch.Generator().manual_seed(seed)
    x, moved = torch.zeros(T, 1, dtype=f64), 0
    for _ in range(n):
        noise = (torch.randn(T, N, 1, generator=g, dtype=f64),) + pit.draw_noise(T, N, x, g)
        a, b = one[1](one[0](x), noise=noise), shard[1](shard[0](x), noise=noise)
        _same(b, a)
        moved += int(a.updated.sum())
        x = a.x
    return moved


@pytest.mark.parametrize("S,N,T", [(4, 512, 8), (2, 256, 12)])
@pytest.mark.parametrize("draws", ["joint", "fused"])
def test_particle_sharded_pit_equals_per_block_max(S, N, T, draws):
    Mt, G0, Gt = mc.pit_model(T, 1, f64, "cpu", seed=S)
    one = pit.get_kernel(Mt, G0, Gt, N, stitch="blocked", draws=draws, block_max="block")
    shard = pit_sharded.get_particle_sharded_kernel(Mt, G0, Gt, N, cpu_mesh(S, PARTICLES),
                                                    draws=draws)
    assert _steps(one, shard, T, N, seed=S) > 0


def test_particle_sharded_pit_checks():
    Mt, G0, Gt = mc.pit_model(8, 1, f64, "cpu", seed=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        pit_sharded.get_particle_sharded_kernel(Mt, G0, Gt, 256, cpu_mesh(4, PARTICLES))
    with pytest.raises(ValueError, match="pair-factorisable"):
        pit_sharded.get_particle_sharded_kernel(Mt, G0, mc.ObsOnly(params=None), 256,
                                                cpu_mesh(2, PARTICLES))
    _, kernel = pit_sharded.get_particle_sharded_kernel(Mt, G0, Gt, 128, cpu_mesh(1, PARTICLES))
    assert kernel.__qualname__ == pit.get_kernel(Mt, G0, Gt, 128)[1].__qualname__
    with pytest.raises(ValueError, match="block_max"):
        pit.get_kernel(Mt, G0, Gt, 128, block_max="column")
    with pytest.raises(ValueError, match="multiple of 128"):
        pit.sharded_block_masses(cpu_mesh(3, PARTICLES), PARTICLES, torch.zeros(1, 4, 1),
                                 torch.zeros(1, 256, 1), torch.zeros(1, 256))


class _Generic(mc.ARObs):
    """ARObs without its pair factors: the generic (N, N) weights."""
    supports_pairwise_factors = False


@pytest.mark.parametrize("C,Tc,N", [(8, 4, 16), (3, 8, 16), (6, 4, 8)])
@pytest.mark.parametrize("factor", [True, False])
def test_time_sharded_pit_equals_one_device(C, Tc, N, factor):
    T = C * Tc
    Mt, G0, Gt = mc.pit_model(T, 1, f64, "cpu", seed=C)
    if not factor:
        Gt = _Generic(params=Gt.params)
    one = pit.get_kernel(Mt, G0, Gt, N)
    shard = pit_sharded.get_sharded_kernel(Mt, G0, Gt, N, cpu_mesh(C, TIME))
    assert _steps(one, shard, T, N, seed=C) > 0


def test_time_sharded_pit_checks():
    Mt, G0, Gt = mc.pit_model(12, 1, f64, "cpu", seed=0)
    init, _ = pit_sharded.get_sharded_kernel(Mt, G0, Gt, 8, cpu_mesh(4, TIME))
    with pytest.raises(ValueError, match="power of two"):  # 12 / 4 = 3
        init(torch.zeros(12, 1, dtype=f64))
    init, _ = pit_sharded.get_sharded_kernel(Mt, G0, Gt, 8, cpu_mesh(5, TIME))
    with pytest.raises(ValueError, match="C \\| T"):
        init(torch.zeros(12, 1, dtype=f64))
    _, kernel = pit_sharded.get_sharded_kernel(Mt, G0, Gt, 8, cpu_mesh(1, TIME))
    assert kernel.__qualname__ == pit.get_kernel(Mt, G0, Gt, 8)[1].__qualname__


# --------------------------------------------------------------------------
# Against JAX, given its noise
# --------------------------------------------------------------------------

def _jax_model(T, seed):
    rng = np.random.default_rng(seed)
    loc, ys = rng.standard_normal((T, 1)), 0.5 * rng.standard_normal((T - 1, 1))
    jM = jind.DiagonalGaussian(loc=jnp.asarray(loc), scale=jnp.full((T,), 0.7))
    from aux_ssm_tpu_torch.kernels.csmc_independent import DiagonalGaussian
    tM = DiagonalGaussian(loc=torch.as_tensor(loc), scale=torch.full((T,), 0.7, dtype=f64))
    return (jM, JG0(), JFactorGt(params=jnp.asarray(ys))), (tM, mc.Prior(),
                                                          mc.ARObs(params=torch.as_tensor(ys)))


def _jax_noise(key, T, N):
    """The port's PIT noise from the key JAX's `_sharded_pit` / `_pit_csmc`
    splits: the proposals' normals per step, then the tree's levels."""
    sample_key, resample_key = jax.random.split(key)
    eps = jnp.stack([jax.random.normal(k, (N, 1), jnp.float64)
                     for k in jax.random.split(sample_key, T)])
    levels, root = jax_tree_noise(jax.random.split(resample_key, T), T, N)
    return (torch.as_tensor(np.array(eps)), levels, root)


@pytest.mark.parametrize("kind", ["time", "particle"])
def test_sharded_pit_step_matches_jax_given_its_noise(kind):
    if kind == "time":
        T, N, S = 16, 16, 8
        jmesh_ = jmesh.make_mesh(devices=jax.devices()[:S], axis_names=(JTIME,))
        (jM, jG0, jGt), (tM, tG0, tGt) = _jax_model(T, 1)
        jinit, jkernel = jps.get_sharded_kernel(jM, jG0, jGt, N, jmesh_)
        tinit, tkernel = pit_sharded.get_sharded_kernel(tM, tG0, tGt, N, cpu_mesh(S, TIME))
    else:
        T, N, S = 8, 256, 2
        jmesh_ = jmesh.make_mesh(devices=jax.devices()[:S], axis_names=(jmesh.PARTICLES,))
        (jM, jG0, jGt), (tM, tG0, tGt) = _jax_model(T, 2)
        jinit, jkernel = jps.get_particle_sharded_kernel(jM, jG0, jGt, N, jmesh_)
        tinit, tkernel = pit_sharded.get_particle_sharded_kernel(tM, tG0, tGt, N,
                                                                 cpu_mesh(S, PARTICLES))
    x0 = np.random.default_rng(3).standard_normal((T, 1))
    key = jax.random.key(7)
    want = jax.jit(jkernel)(key, jinit(jnp.asarray(x0)))
    got = tkernel(tinit(torch.as_tensor(x0)), noise=_jax_noise(key, T, N))
    np.testing.assert_array_equal(got.updated.numpy(), np.asarray(want.updated))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9, atol=1e-12)
    assert int(np.asarray(want.updated).sum()) > 0
