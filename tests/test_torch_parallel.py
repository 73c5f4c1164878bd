"""The port's multi-device layer (`aux_ssm_tpu_torch/parallel/`) on shards of
"cpu", against the port's own one-device functions and against the JAX
package's sharded functions on its 8 virtual CPU devices.

- Meshes: sizes, an inferred axis, bad sizes raising, no card raising (no
  CPU fallback), placement of a tree over a `chains` axis.
- Collectives: all_gather, psum, pmax and ppermute in shard order.
- Resampling: `sharded_conditional_resample` and its streaming variant at S
  = 8 and S = 3, multinomial and systematic, bit-equal to the one-device
  draw and take; `sharded_normalize` against JAX's at rtol 1e-12.
- Time scans: `sharded_filtering_scan` and `sharded_sampling_scan` against
  the port's one-device scans at rtol 1e-12 (S dividing T and not), and
  against JAX's on 8 devices at T = 29, float64, rtol 1e-9 (the block scans
  reassociate differently).
- The chains mesh: one shard bit for bit the run without a mesh; two shards
  each bit for bit a one-process batched run of its chains with its shard
  generator; a killed run on a mesh resumes bit for bit; the aggregated
  statistics by psum equal the plain means to rtol 1e-12.
- Batch sharding: one spatial kalman-1 step against the JAX package's
  batch-sharded step given JAX's noise, float64, rtol 1e-9, the same accept;
  the port's sharded step equals its unsharded one (rtol 1e-12, the same
  accept); the driver's `--batch-sharded 2` on the CPU; the flags raising.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.parallel import batch as jbatch  # noqa: E402
from aux_ssm_tpu.parallel import mesh as jmesh  # noqa: E402
from aux_ssm_tpu.parallel import resampling as jres  # noqa: E402
from aux_ssm_tpu.parallel import time_scan as jts  # noqa: E402
from aux_ssm_tpu_torch.experiments import cli, multichip, runner  # noqa: E402
from aux_ssm_tpu_torch.experiments import spatial as tspatial  # noqa: E402
from aux_ssm_tpu_torch.experiments.runner import RunConfig  # noqa: E402
from aux_ssm_tpu_torch.ops import resampling as rs  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda.filter_scan import affine_scan_plain, filter_scan_plain  # noqa: E402
from aux_ssm_tpu_torch.parallel import collectives as col  # noqa: E402
from aux_ssm_tpu_torch.parallel import resampling as pres  # noqa: E402
from aux_ssm_tpu_torch.parallel import time_scan as pts  # noqa: E402
from aux_ssm_tpu_torch.parallel.batch import batch_sharded_kernel  # noqa: E402
from aux_ssm_tpu_torch.parallel.chains import (ShardGenerators, aggregate_chain_stats,  # noqa: E402
                                               run_sharded_chains, shard_chains, shard_seed)
from aux_ssm_tpu_torch.parallel.mesh import (BATCH, CHAINS, PARTICLES, make_mesh,  # noqa: E402
                                             replicated)

f64 = torch.float64


def cpu_mesh(S, axis):
    return make_mesh(devices=["cpu"] * S, axis_names=(axis,))


def jax_mesh(S, axis):
    return jmesh.make_mesh(devices=jax.devices()[:S], axis_names=(axis,))


# --------------------------------------------------------------------------
# Meshes and collectives
# --------------------------------------------------------------------------

def test_mesh_sizes_and_errors():
    m = make_mesh((2, -1), ["cpu"] * 8, (CHAINS, PARTICLES))
    assert m.shape == {CHAINS: 2, PARTICLES: 4} and m.size == 8
    assert m.local_shards(PARTICLES) == [0, 1, 2, 3]
    assert m.axis_devices(CHAINS) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="do not multiply"):
        make_mesh((3,), ["cpu"] * 8)
    with pytest.raises(ValueError, match="no axis"):
        m.axis_devices(BATCH)
    with pytest.raises(ValueError, match="device_count"):  # no card here: no CPU fallback
        make_mesh()
    tree = {"x": torch.arange(8.0).reshape(4, 2), "n": torch.arange(4)}
    parts = shard_chains(make_mesh((2,), ["cpu"] * 2), tree)
    assert [p["n"].tolist() for p in parts] == [[0, 1], [2, 3]]
    whole = replicated(make_mesh((2,), ["cpu"] * 2)).place(tree)
    assert all(torch.equal(p["x"], tree["x"]) for p in whole)


def test_collectives_in_shard_order():
    m = cpu_mesh(4, PARTICLES)
    parts = [torch.full((2,), float(s)) for s in range(4)]
    assert torch.equal(col.gather(m, parts, 0, PARTICLES),
                       torch.tensor([0.0, 0, 1, 1, 2, 2, 3, 3]))
    assert all(torch.equal(z, torch.full((2,), 6.0)) for z in col.psum(m, parts, PARTICLES))
    assert all(torch.equal(z, torch.full((2,), 3.0)) for z in col.pmax(m, parts, PARTICLES))
    ring = col.ppermute(m, parts, [(j, (j + 1) % 4) for j in range(4)], PARTICLES)
    assert [int(z[0]) for z in ring] == [3, 0, 1, 2]
    assert col.axis_index(m, PARTICLES) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not split"):
        col.split(m, torch.zeros(6), 0, PARTICLES)


# --------------------------------------------------------------------------
# Resampling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [8, 3])
@pytest.mark.parametrize("scheme", ["multinomial", "systematic"])
def test_sharded_resample_bitwise(S, scheme):
    g = torch.Generator().manual_seed(S)
    N = 24
    w = torch.rand(N, generator=g, dtype=f64)
    w = w / w.sum()
    p = torch.randn(N, 3, generator=g, dtype=f64)
    m = cpu_mesh(S, PARTICLES)
    for _ in range(3):
        u = pres.scheme_noise(scheme, N, w, g)
        draw = rs.multinomial_from_uniforms if scheme == "multinomial" else \
            rs.systematic_from_uniforms
        want = p[draw(u, w)]
        assert torch.equal(pres.sharded_conditional_resample(m, w, p, u, scheme), want)
        assert torch.equal(pres.sharded_conditional_resample_streaming(m, w, p, u, scheme),
                           want)
        assert torch.equal(want[0], p[0])  # index 0 pinned
    with pytest.raises(ValueError, match="unknown"):
        pres.sharded_conditional_resample(m, w, p, u, "stratified")


def test_sharded_normalize_matches_jax():
    lw = np.random.default_rng(0).standard_normal(64) * 3
    want = jres.sharded_normalize(jax_mesh(8, jmesh.PARTICLES), jnp.asarray(lw))
    got = pres.sharded_normalize(cpu_mesh(8, PARTICLES), torch.as_tensor(lw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)


# --------------------------------------------------------------------------
# Time scans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [32, 29])
def test_time_scans_match_the_one_device_scans(n):
    elems, (gains, incs) = multichip.scan_inputs(n, 3, f64, "cpu", seed=n)
    tm = cpu_mesh(8, pts.TIME)
    for got, one in ((pts.sharded_filtering_scan(tm, elems), filter_scan_plain(elems)),
                     (pts.sharded_sampling_scan(tm, (gains, incs)),
                      affine_scan_plain(gains, incs, reverse=True))):
        for g_, o in zip(got, one):
            np.testing.assert_allclose(g_.numpy(), o.numpy(), rtol=1e-12, atol=1e-13)


def test_time_scans_match_jax():
    """n = 29 over 8 shards: the tail padded with edge copies in both."""
    n = 29
    elems, (gains, incs) = multichip.scan_inputs(n, 3, f64, "cpu", seed=n)
    tm, jm = cpu_mesh(8, pts.TIME), jax_mesh(8, jts.TIME)
    jf = jax.jit(lambda e: jts.sharded_filtering_scan(jm, e))
    js = jax.jit(lambda g, e: jts.sharded_sampling_scan(jm, (g, e)))
    for got, want in ((pts.sharded_filtering_scan(tm, elems),
                       jf(tuple(jnp.asarray(z.numpy()) for z in elems))),
                      (pts.sharded_sampling_scan(tm, (gains, incs)),
                       js(jnp.asarray(gains.numpy()), jnp.asarray(incs.numpy())))):
        for g_, j_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(j_), rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------------
# The chains mesh
# --------------------------------------------------------------------------

CFG = RunConfig(n_samples=12, burnin=8, delta_init=0.5)


def _mh(state, delta, generator=None):
    """Random-walk MH on N(0, I) over a chain axis (x (C, 4), delta (C,))."""
    x = state.x
    prop = x + torch.sqrt(delta)[:, None] * torch.randn(x.shape, generator=generator, dtype=x.dtype)
    log_a = 0.5 * (x * x - prop * prop).sum(-1)
    accept = torch.rand(x.shape[0], generator=generator, dtype=x.dtype).log() < log_a
    return runner_state(torch.where(accept[:, None], prop, x), accept)


def runner_state(x, updated):
    from aux_ssm_tpu_torch.kernels.kalman import KalmanSampler
    return KalmanSampler(x=x, updated=updated)


def _chains(C):
    return runner_state(torch.zeros(C, 4, dtype=f64), torch.zeros(C, dtype=torch.bool))


def _same(a, b):
    assert torch.equal(a.state.x, b.state.x) and torch.equal(a.delta, b.delta)
    np.testing.assert_array_equal(a.samples, b.samples)
    for f in ("mean_x", "accept_cum", "ejsd"):
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f))


def test_one_shard_mesh_is_the_run_without_a_mesh():
    plain = run_sharded_chains(_mh, _chains(6), CFG, generator=torch.Generator().manual_seed(1),
                               collect_samples=True)
    meshed = run_sharded_chains(_mh, _chains(6), CFG, generator=torch.Generator().manual_seed(1),
                                collect_samples=True, mesh=cpu_mesh(1, CHAINS))
    _same(meshed, plain)


def test_each_shard_is_a_batched_run_with_its_generator():
    C, S, seed = 6, 2, 3
    meshed = run_sharded_chains(_mh, _chains(C), CFG,
                                generator=torch.Generator().manual_seed(seed),
                                collect_samples=True, mesh=cpu_mesh(S, CHAINS))
    n = C // S
    for s in range(S):
        one = run_sharded_chains(_mh, _chains(n), CFG,
                                 generator=torch.Generator().manual_seed(shard_seed(seed, s)),
                                 collect_samples=True)
        sl = slice(s * n, (s + 1) * n)
        assert torch.equal(meshed.state.x[sl], one.state.x)
        assert torch.equal(meshed.delta[sl], one.delta)
        np.testing.assert_array_equal(meshed.samples[sl], one.samples)
        assert torch.equal(meshed.stats.accept_cum[sl], one.stats.accept_cum)
    agg = aggregate_chain_stats(meshed.stats, cpu_mesh(S, CHAINS))
    np.testing.assert_allclose(agg.mean_x.numpy(), meshed.stats.mean_x.mean(0).numpy(),
                               rtol=1e-12)
    gens = ShardGenerators(cpu_mesh(S, CHAINS), torch.Generator().manual_seed(seed))
    state = gens.get_state()
    first = [torch.rand(2, generator=g) for g in gens.shards]
    gens.set_state(state)
    assert all(torch.equal(torch.rand(2, generator=g), f) for g, f in zip(gens.shards, first))


def test_mesh_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    mesh = cpu_mesh(2, CHAINS)

    def run(directory):
        return run_sharded_chains(_mh, _chains(4), CFG, generator=torch.Generator().manual_seed(9),
                                  collect_samples=True, mesh=mesh, checkpoint_dir=directory,
                                  checkpoint_every=5)
    full = run(str(tmp_path / "full"))
    save, calls = runner._save, []

    def dying(*a, **kw):
        save(*a, **kw)
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
    monkeypatch.setattr(runner, "_save", dying)
    with pytest.raises(KeyboardInterrupt):
        run(str(tmp_path / "cut"))
    monkeypatch.setattr(runner, "_save", save)
    _same(run(str(tmp_path / "cut")), full)


def test_mesh_devices_of_the_flag():
    assert cli.mesh_devices(argparse.Namespace(mesh_chains=0)) is None
    assert cli.mesh_devices(argparse.Namespace(mesh_chains=3, platform="cpu")) == ["cpu"] * 3
    with pytest.raises(ValueError, match="asks for 2 cards; this machine has 0"):
        cli.mesh_devices(argparse.Namespace(mesh_chains=2, platform=None))


# --------------------------------------------------------------------------
# Batch sharding
# --------------------------------------------------------------------------

SP = dict(sigma_x=0.3, nu=4.0, tau=-0.25, r_y=1.0)


def _spatial(D, T, seed):
    from aux_ssm_tpu.models import spatial as jsp
    xs, ys = jsp.get_data(np.random.default_rng(seed), SP["sigma_x"], SP["r_y"], SP["tau"],
                          SP["nu"], D, T)
    return np.asarray(xs), np.asarray(ys)


def test_batch_sharded_step_matches_jax():
    """JAX's `batch_sharded_kernel` on 4 of its devices against the port's on
    4 CPU shards, D = 4 (B = 16), T = 16, given JAX's noise."""
    from aux_ssm_tpu.models import spatial as jsp
    from aux_ssm_tpu_torch.models import spatial as tsp
    D, T = 4, 16
    B = D * D
    xs, ys = _spatial(D, T, 3)
    args = (SP["sigma_x"], SP["nu"], SP["tau"], SP["r_y"], D)
    jinit, jkernel = jsp.get_kalman_kernel(jnp.asarray(ys), *args, parallel=True, order=1)
    jk = jax.jit(jbatch.batch_sharded_kernel(jkernel, jax_mesh(4, jmesh.BATCH)))
    tinit, tkernel = tsp.get_kalman_kernel(torch.as_tensor(ys), *args, True, order=1)
    tk = batch_sharded_kernel(tkernel, cpu_mesh(4, BATCH))
    x0 = xs + 0.2 * np.random.default_rng(1).standard_normal(xs.shape)
    jstate = jinit(jnp.asarray(x0)[..., None])
    tstate = tinit(torch.as_tensor(x0))
    moved = 0
    for key in jax.random.split(jax.random.key(4), 3):
        aux_key, sample_key, accept_key = jax.random.split(key, 3)
        noise = (jax.random.normal(aux_key, (T, B, 1), jnp.float64),
                 jax.random.normal(sample_key, (T, B, 1), jnp.float64),
                 jax.random.uniform(accept_key, (), jnp.float64))
        jstate = jk(key, jstate, jnp.asarray(0.05))
        tstate = tk(tstate, 0.05, noise=tuple(torch.as_tensor(np.array(z)) for z in noise))
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
        moved += int(bool(jstate.updated))
    assert moved > 0


def test_batch_sharded_step_equals_the_unsharded_step_and_the_driver_runs(tmp_path):
    out = multichip.dryrun_batch(["cpu"] * 4, f64, seed=5)
    assert out["same_accept"] and out["max_abs"] <= 1e-12
    argv = ["--T", "16", "--D", "2", "--n-samples", "4", "--burnin", "4", "--platform", "cpu",
            "--no-verbose", "--precision", "double"]
    sharded = tspatial.main(argv + ["--batch-sharded", "2"])
    plain = tspatial.main(argv)
    np.testing.assert_allclose(sharded.state.x.numpy(), plain.state.x.numpy(), rtol=1e-12)
    for extra, msg in ((["--style", "csmc-guided", "--batch-sharded", "2"], "kalman styles"),
                       (["--n-chains", "2", "--batch-sharded", "2"], "pick one"),
                       (["--batch-sharded"], "shard count")):
        with pytest.raises(ValueError, match=msg):
            tspatial.main(argv + extra)
    with pytest.raises(ValueError, match="batched layout"):
        batch_sharded_kernel(lambda *a: None, cpu_mesh(2, BATCH))
