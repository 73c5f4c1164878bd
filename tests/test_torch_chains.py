"""Several chains on one card (`aux_ssm_tpu_torch/parallel/chains.py`):
`run_sharded_chains` over a leading chain axis, through `run_chain`'s loop
(one chain bit for bit as `run_chain`; each chain's delta adapting on its own
rate; a killed run resuming bit for bit), `aggregate_chain_stats`, the chain
loop that runs a one-chain kernel chain after chain, and the split-R-hat of
`experiments.cli.run_maybe_sharded` against the JAX package's formulas on the
same samples.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.utils import ess as jess  # noqa: E402
from aux_ssm_tpu_torch.experiments import cli, runner  # noqa: E402
from aux_ssm_tpu_torch.experiments.runner import RunConfig, run_chain  # noqa: E402
from aux_ssm_tpu_torch.kernels.kalman import KalmanSampler  # noqa: E402
from aux_ssm_tpu_torch.models import rare_event as tre  # noqa: E402
from aux_ssm_tpu_torch.parallel import (aggregate_chain_stats, broadcast_chains,  # noqa: E402
                                        chain_loop, run_sharded_chains)
from aux_ssm_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

CFG = RunConfig(n_samples=24, burnin=20, delta_init=0.5)
INIT = KalmanSampler(x=torch.zeros(4, dtype=torch.float64), updated=torch.tensor(False))


def _mh(state, delta, generator=None):
    """Random-walk MH on N(0, I), one chain (x (4,)) or C chains (x (C, 4),
    delta (C,)) at once: it accepts and rejects, so delta adapts."""
    x = state.x
    delta = torch.as_tensor(delta, dtype=x.dtype)
    step = torch.sqrt(delta)[..., None] if x.dim() > 1 else torch.sqrt(delta)
    prop = x + step * torch.randn(x.shape, generator=generator, dtype=x.dtype)
    log_a = 0.5 * (x ** 2 - prop ** 2).sum(-1)
    acc = torch.log(torch.rand(x.shape[:-1], generator=generator, dtype=x.dtype)) < log_a
    keep = acc[..., None] if x.dim() > 1 else acc
    return KalmanSampler(x=torch.where(keep, prop, x), updated=acc)


def _same(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), (a, b)
    else:
        assert a == b


def _first_chain(tree):
    return type(tree)(**{f.name: None if getattr(tree, f.name) is None
                         else getattr(tree, f.name)[0] for f in dataclasses.fields(tree)})


@pytest.mark.parametrize("batched", [False, True], ids=["chain-loop", "batched"])
def test_one_chain_equals_run_chain_bit_for_bit(batched):
    want = run_chain(_mh, INIT, CFG, generator=torch.Generator().manual_seed(1),
                     collect_samples=True)
    got = run_sharded_chains(_mh if batched else chain_loop(_mh), broadcast_chains(INIT, 1), CFG,
                             generator=torch.Generator().manual_seed(1), collect_samples=True)
    assert got.samples.shape == (1, CFG.n_samples, 4) and got.stats.step.shape == (1,)
    np.testing.assert_array_equal(got.samples[0], want.samples)
    _same(_first_chain(got.state), want.state)
    _same(got.delta[0], want.delta)
    _same(_first_chain(got.stats), want.stats)


def _fixed_rate(state, delta, generator=None):
    """Chain c accepts at its own fixed pattern: chain 0 always, chain 1
    never, chain 2 every other step (as a one-chain kernel, x[0] its
    index)."""
    c, k = int(state.x[0]), int(state.x[1])
    acc = torch.tensor([True, False, k % 2 == 0][c])
    return KalmanSampler(x=state.x + torch.tensor([0.0, 1.0]), updated=acc)


def test_each_chain_delta_adapts_on_its_own_rate():
    cfg = RunConfig(n_samples=5, burnin=30, delta_init=0.5)
    init = KalmanSampler(x=torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]),
                         updated=torch.zeros(3, dtype=torch.bool))
    res = run_sharded_chains(chain_loop(_fixed_rate), init, cfg)
    for c in range(3):
        one = run_chain(_fixed_rate, KalmanSampler(x=init.x[c], updated=init.updated[c]), cfg)
        _same(res.delta[c], one.delta)
        _same(_first_chain(dataclasses.replace(
            res.stats, **{f.name: getattr(res.stats, f.name)[c:]
                          for f in dataclasses.fields(res.stats)})), one.stats)
    assert res.delta[0] > 0.5 > res.delta[1]


def test_aggregate_chain_stats_is_the_mean_over_chains():
    res = run_sharded_chains(_mh, broadcast_chains(INIT, 3), CFG,
                             generator=torch.Generator().manual_seed(2))
    agg = aggregate_chain_stats(res.stats)
    for f in dataclasses.fields(res.stats):
        z = getattr(res.stats, f.name)
        torch.testing.assert_close(getattr(agg, f.name), z.double().mean(0) if f.name == "step"
                                   else z.mean(0), rtol=0, atol=0)
    assert float(agg.step) == CFG.n_samples


def test_killed_three_chain_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    def run(**kw):
        return run_sharded_chains(_mh, broadcast_chains(INIT, 3), CFG,
                                  generator=torch.Generator().manual_seed(3),
                                  collect_samples=True, **kw)

    want = run()

    class Killed(RuntimeError):
        pass

    save, calls = runner._save, []

    def dying_save(directory, payload, step):
        save(directory, payload, step)
        calls.append(step)
        if len(calls) == 4:  # after the first sampling segment
            raise Killed()

    monkeypatch.setattr(runner, "_save", dying_save)
    with pytest.raises(Killed):
        run(checkpoint_dir=str(tmp_path), checkpoint_every=8)
    monkeypatch.setattr(runner, "_save", save)
    assert ckpt.latest_step(tmp_path) == calls[-1] >= 10 ** 9
    got = run(checkpoint_dir=str(tmp_path), checkpoint_every=8)
    np.testing.assert_array_equal(got.samples, want.samples)
    _same(got.state, want.state)
    _same(got.delta, want.delta)
    _same(got.stats, want.stats)


def test_chain_loop_chain_equals_one_chain_step_given_noise():
    T, Nn, Cc = 6, 8, 3
    init, kernel = tre.get_guided_csmc_kernel(5.0, 0.8, 0.5, T, Nn, device="cpu",
                                              gradient=True)
    gen = torch.Generator().manual_seed(4)
    xs = [tre.init_x(5.0, 0.8, 0.5, T, generator=gen, device="cpu") for _ in range(Cc)]
    delta = torch.rand(Cc, T, generator=gen, dtype=torch.float64) + 0.3
    noise = [(torch.randn(T, 1, generator=gen, dtype=torch.float64),
              torch.randn(Nn, 1, generator=gen, dtype=torch.float64),
              torch.rand(T - 1, Nn, generator=gen, dtype=torch.float64),
              torch.randn(T - 1, Nn, 1, generator=gen, dtype=torch.float64),
              torch.rand(T - 1, generator=gen, dtype=torch.float64),
              torch.rand(T, generator=gen, dtype=torch.float64)) for _ in range(Cc)]
    stacked = tuple(torch.stack(z) for z in zip(*noise))
    out = chain_loop(kernel)(init(torch.stack(xs)), delta, noise=stacked)
    for c in range(Cc):
        one = kernel(init(xs[c]), delta[c], noise=noise[c])
        assert torch.equal(out.x[c], one.x) and torch.equal(out.updated[c], one.updated)


@pytest.mark.parametrize("collect", [True, False])
def test_run_maybe_sharded_rhat_matches_jax(collect):
    args = argparse.Namespace(n_chains=3, mesh_chains=0, checkpoint_dir=None,
                              checkpoint_every=0)
    init = KalmanSampler(x=torch.zeros(300, dtype=torch.float64), updated=torch.tensor(False))
    cfg = RunConfig(n_samples=40, burnin=10, delta_init=0.5)
    res, diag = cli.run_maybe_sharded(torch.Generator().manual_seed(5), _mh, init, cfg, args,
                                      collect_samples=collect)
    assert diag["n_chains"] == 3 and diag["stats"].mean_x.shape == (300,)
    if collect:
        flat = res.samples.reshape(3, cfg.n_samples, -1)
        take = np.unique(np.linspace(0, 299, 128).astype(int))
        want = jax.vmap(jess.potential_scale_reduction, in_axes=2)(jnp.asarray(flat[:, :, take]))
    else:
        mean = res.stats.mean_x.numpy()
        want = jess.rhat_from_moments(mean, res.stats.mean_x2.numpy() - mean ** 2,
                                      cfg.n_samples).ravel()
    np.testing.assert_allclose(diag["rhat_max"], float(jnp.max(want)), rtol=1e-9)
    np.testing.assert_allclose(diag["rhat_median"], float(jnp.median(want)), rtol=1e-9)
    assert "3 chains" in cli.chain_summary(res, diag, cfg)


def test_mesh_raises_naming_the_queue():
    """A chains mesh whose shards do not divide the chains raises, and so
    does `--mesh-chains` above the card count (none here)."""
    from aux_ssm_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="do not divide"):
        run_sharded_chains(_mh, broadcast_chains(INIT, 2), CFG, mesh=make_mesh(devices=["cpu"] * 3),
                           generator=torch.Generator().manual_seed(0))
    args = argparse.Namespace(n_chains=2, mesh_chains=2)
    with pytest.raises(ValueError, match="asks for 2 cards; this machine has 0"):
        cli.run_maybe_sharded(None, _mh, INIT, CFG, args)
