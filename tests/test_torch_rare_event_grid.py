"""The rare-event grid as one batched sampler over a flat chain axis
(`experiments/rare_event.py`) against the JAX package's vmapped grid kernel
(`make_batched_kernel`): one step of every style, without and with the
gradient shift, at T = 2 (the published grid's) and T = 6 (the PIT tree's
col_sample levels), on a 2 x 2 grid x 2 chains, given each chain's noise as
JAX draws it from its `fold_in(key, i)` key (float64, rtol 1e-9, accepts and
indices identical); the batched exact initial draw; the driver in law
against the closed form; and launches a step that do not grow with the
number of chains.
"""
import argparse
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.experiments import rare_event as jdriver  # noqa: E402
from aux_ssm_tpu.models import rare_event as jre  # noqa: E402
from aux_ssm_tpu_torch import rare_event_grid_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.experiments import rare_event as tdriver  # noqa: E402
from aux_ssm_tpu_torch.experiments.cli import base_parser  # noqa: E402
from aux_ssm_tpu_torch.models import rare_event as tre  # noqa: E402
from aux_ssm_tpu_torch.ops import stitching as plain_stitching  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import csmc_fwd, scalar_scan, stitching  # noqa: E402
from test_torch_pit import jax_step_noise  # noqa: E402
from test_torch_rare_event import _csmc_noise, _kalman_noise  # noqa: E402

f64 = jnp.float64
CPU = dict(device="cpu", dtype=torch.float64)
Y, N, G, C = 5.0, 8, 2, 2
# style -> (JAX style, parallel): "csmc" is the PIT cSMC (the drivers'
# --parallel default), "csmc-seq" the sequential sweep (--no-parallel).
STYLES = {"kalman": ("kalman-1", True), "csmc": ("csmc", True),
          "csmc-seq": ("csmc", False), "csmc-guided": ("csmc-guided", True)}


def _t(z):
    return torch.as_tensor(np.array(z))


def _args(style, T, gradient):
    name, parallel = STYLES[style]
    return argparse.Namespace(y=Y, T=T, parallel=parallel, gradient=gradient,
                              n_particles=N, backward=True, style=name)


def _cells(grid=G, chains=C):
    rho, r2 = tdriver.grid_cells(grid)
    return np.repeat(rho, chains), np.repeat(r2, chains)


def _chain_noise(style, key, T):
    if style == "kalman":
        return _kalman_noise(key, T)
    if style == "csmc":
        return jax_step_noise(key, T, N, 1)
    return tuple(_t(z) for z in _csmc_noise(key, T))


def _stack(noises):
    """Per-chain noise trees stacked on a leading chain axis."""
    first = noises[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([n[i] for n in noises]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(np.array(z)) for z in noises])


def test_grid_cells_match_jax():
    rho, r2 = tdriver.grid_cells(10)
    want = [z.ravel() for z in np.meshgrid(np.linspace(0.0, 0.999, 10), np.logspace(-3, 0, 10),
                                           indexing="ij")]
    np.testing.assert_array_equal(rho, want[0])
    np.testing.assert_array_equal(r2, want[1])


@pytest.mark.parametrize("T,parallel", [(2, False), (6, True)])
def test_batched_init_x_matches_jax_vmap(T, parallel):
    rho, r2 = _cells()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(T), i))(jnp.arange(len(rho)))
    want = jax.jit(jax.vmap(lambda k, a, b: jre.init_x(k, Y, a, b, T, parallel)))(
        keys, jnp.asarray(rho), jnp.asarray(r2))
    eps = jax.vmap(lambda k: jax.random.normal(k, (T, 1), f64))(keys)
    got = tre.init_x(Y, torch.as_tensor(rho), torch.as_tensor(r2), T, parallel, eps=_t(eps),
                     **CPU)
    assert got.shape == (len(rho), T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("style,gradient,T", [
    (style, gradient, T) for style in ("kalman", "csmc", "csmc-guided")
    for gradient in (False, True) for T in (2, 6)] + [("csmc-seq", False, 6)])
def test_batched_step_matches_jax_per_chain(style, gradient, T):
    args = _args(style, T, gradient)
    rho, r2 = _cells()
    M = len(rho)
    csmc = style != "kalman"
    x0 = np.asarray(jax.vmap(lambda k, a, b: jre.init_x(k, Y, a, b, T))(
        jax.random.split(jax.random.key(1), M), jnp.asarray(rho), jnp.asarray(r2)))
    delta = (np.random.default_rng(T).uniform(0.3, 1.5, (M, T)) if csmc
             else np.random.default_rng(T).uniform(0.3, 1.5, M))
    upd = np.zeros((M, T) if csmc else (M,), bool)
    jstate = jdriver.GridState(x=jnp.asarray(x0), updated=jnp.asarray(upd),
                               rho=jnp.asarray(rho), r2=jnp.asarray(r2))
    jkernel = jax.jit(jdriver.make_batched_kernel(args.style, args))
    tkernel = tdriver.make_batched_kernel(args.style, args, torch.as_tensor(rho),
                                          torch.as_tensor(r2), **CPU)
    tstate, tdelta = rare_event_grid_from_numpy(x0, rho, r2, upd, delta, **CPU)
    for key in jax.random.split(jax.random.key(11), 2):
        jstate = jkernel(key, jstate, jnp.asarray(delta))
        noise = _stack([_chain_noise(style, jax.random.fold_in(key, i), T) for i in range(M)])
        tstate = tkernel(tstate, tdelta, noise=noise)
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
    assert tstate.updated.any()


def _counting(monkeypatch):
    """Count the calls of every kernel wrapper a grid step can reach, where
    the step's modules call them (on the CPU a wrapper runs its plain
    version; on the card each call is its launches)."""
    filtering = importlib.import_module("aux_ssm_tpu_torch.ops.filtering")
    sampling = importlib.import_module("aux_ssm_tpu_torch.ops.sampling")
    calls = {}
    for mod, names in ((csmc_fwd, ("forward_factor_scan", "backward_factor_scan", "lane_scan")),
                       (filtering, ("scalar_filter_scan",)), (sampling, ("scalar_affine_scan",)),
                       (stitching, ("row_lse", "col_sample"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=name, **kw: (
                calls.__setitem__(_k, calls.get(_k, 0) + 1), _f(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("style,T", [("kalman", 2), ("csmc", 6), ("csmc-seq", 2),
                                     ("csmc-guided", 2)])
def test_calls_a_step_do_not_grow_with_the_chains(monkeypatch, style, T):
    args = _args(style, T, False)
    counts = {}
    for grid, chains in ((1, 1), (2, 2)):
        calls = _counting(monkeypatch)
        rho, r2 = (torch.as_tensor(z) for z in _cells(grid, chains))
        M = rho.shape[0]
        kernel = tdriver.make_batched_kernel(args.style, args, rho, r2, **CPU)
        gen = torch.Generator().manual_seed(0)
        csmc = style != "kalman"
        state = tdriver.GridState(
            x=tre.init_x(Y, rho, r2, T, generator=gen, **CPU),
            updated=torch.zeros((M, T) if csmc else (M,), dtype=torch.bool), rho=rho, r2=r2)
        delta = torch.full((M, T) if csmc else (M,), 0.5, dtype=torch.float64)
        for _ in range(3):
            state = kernel(state, delta, generator=gen)
        counts[M] = dict(calls)
        monkeypatch.undo()
    assert counts[1] == counts[8] and sum(counts[1].values()) > 0, counts


def _driver_args(style, **over):
    p = base_parser("t")
    p.add_argument("--T", type=int, default=2)
    p.add_argument("--y", type=float, default=3.0)
    p.add_argument("--grid-size", type=int, default=2)
    defaults = dict(n_chains=3, style=style, n_samples=1000, burnin=300, verbose=False,
                    n_particles=16)
    defaults.update(over)
    p.set_defaults(**defaults)
    return p.parse_args([])


@pytest.mark.parametrize("style", ["kalman-1", "csmc"])
def test_run_grid_recovers_closed_form(style):
    """As the JAX package's tests/test_rare_event_driver.py: pooled over 3
    chains, every cell's moments against the closed form, a healthy
    split-R-hat, one sampling time for the whole sweep, and per-chain deltas
    that moved apart across cells."""
    rows, res = tdriver.run_grid(_driver_args(style), device="cpu", dtype=torch.float64)
    assert len(rows) == 4
    for r in rows:
        assert r["ess_T"] > 50, r
        assert r["err_mean_T"] < 25.0 / r["ess_T"], r
        assert abs(r["err_std_T"]) < 0.2, r
        assert 0.95 < r["rhat_T"] < 1.2, r
        assert 0.0 < r["acc"] < 1.0, r
    assert all(r["time"] == rows[0]["time"] for r in rows)
    assert res.samples.shape == (12, 1000, 2, 1) and res.stats.step.shape == (12,)
    assert np.unique(np.round(res.delta.numpy(), 6)).size > 1


def test_driver_main_writes_csv_and_heatmaps(tmp_path):
    out = tmp_path / "grid.csv"
    rows = tdriver.main(["--platform", "cpu", "--precision", "double", "--grid-size", "2",
                         "--n-chains", "2", "--n-samples", "40", "--burnin", "10",
                         "--no-verbose", "--out", str(out), "--figures-dir",
                         str(tmp_path / "figs")])
    assert len(rows) == 4
    lines = out.read_text().splitlines()
    assert lines[0].split(",")[:3] == ["rho", "r2", "err_mean_0"] and len(lines) == 5
    assert (tmp_path / "figs" / "rare_event_summary.csv").exists()


def test_mesh_chains_raise():
    """`--mesh-chains` above the card count raises (no card here), and so
    does a shard count that does not divide the grid's M = 2^2 x 3 chains."""
    with pytest.raises(ValueError, match="asks for 2 cards; this machine has 0"):
        tdriver.run_grid(_driver_args("kalman-1", mesh_chains=2), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tdriver.run_grid(_driver_args("kalman-1", mesh_chains=5, platform="cpu"), device="cpu")


def test_col_sample_chain_seeds_draw_each_chain_as_one_chain_call():
    """col_sample's chain axis (the plain version here, the kernel on the
    card and through the host build): chain c's pairs with seed c equal a
    one-chain call with that seed."""
    g = torch.Generator().manual_seed(5)
    Cc, P, n, Nc, k = 3, 4, 6, 8, 2
    rf, cf = torch.randn(Cc * P, n, k, generator=g), torch.randn(Cc * P, Nc, k, generator=g)
    cb = torch.randn(Cc * P, Nc, generator=g)
    seeds = torch.tensor([7, 123456, 2 ** 30], dtype=torch.int32)
    got = stitching.col_sample(seeds, rf, cf, cb, pair_offset=2, chains=Cc)
    for c in range(Cc):
        sl = slice(c * P, (c + 1) * P)
        want = plain_stitching.col_sample(seeds[c], rf[sl], cf[sl], cb[sl], 2)
        np.testing.assert_array_equal(got[sl].numpy(), want.numpy())
    one = stitching.col_sample(seeds[:1], rf, cf, cb, chains=1)
    np.testing.assert_array_equal(one.numpy(), stitching.col_sample(seeds[0], rf, cf, cb).numpy())
