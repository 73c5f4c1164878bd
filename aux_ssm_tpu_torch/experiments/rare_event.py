"""Rare-event experiment driver (counterpart of
`aux_ssm_tpu/experiments/rare_event.py`): a grid over (rho, r2), several
chains a cell, ESS, split-R-hat and moment errors against the closed-form
conditionals.

The whole sweep, every (rho, r2) cell times every chain, is one batched
sampler over a flat chain axis of M = grid^2 x n_chains: the model builders
take (M,) rho and r2 (`models/rare_event.py`), so a step of all M chains is
one set of launches (kalman: the scalar scans in the batched scalar layout;
csmc-guided: the lane and backward factor sweeps; csmc: the PIT tree's
stitching kernels), and each chain's delta adapts on its own rate
(`parallel.chains.run_sharded_chains`). `--mesh-chains n` puts the M
chains on a `chains` mesh of n shards (n cards, or n CPU shards under
`--platform cpu`; n must divide M), each shard's kernel built on its own
M/n cells.

    python -m aux_ssm_tpu_torch.experiments.rare_event --precision double \
        --grid-size 10 --n-chains 8 --out grid.csv --figures-dir figs
    python -m aux_ssm_tpu_torch.experiments.rare_event --platform cpu \
        --grid-size 2 --n-chains 3 --n-samples 200 --burnin 50
"""
import csv
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.csmc_base import CSMCState
from ..kernels.kalman import KalmanSampler
from ..models import rare_event as re_model
from ..parallel.chains import run_sharded_chains
from ..parallel.mesh import CHAINS, make_mesh
from ..utils.ess import effective_sample_size, potential_scale_reduction
from . import cli


@dataclass(frozen=True)
class GridState:
    """The batched sampler's state, each chain with its (rho, r2) cell."""
    x: torch.Tensor        # (M, T, 1)
    updated: torch.Tensor  # (M,) kalman styles, (M, T) csmc styles
    rho: torch.Tensor      # (M,)
    r2: torch.Tensor       # (M,)


def make_batched_kernel(style, args, rho, r2, *, dtype=torch.float64, device=None):
    """The kernel over the flat chain axis of the M chains whose cells are
    rho, r2 (M,): `kernel(state, delta, generator=None, noise=None) ->
    GridState`, delta (M,) (kalman) or (M, T) (csmc), `noise` each chain's
    noise stacked on a leading axis of M in the one-chain kernels' order
    (`models/rare_event.py`; kalman: (M, T, 1), (M, T, 1), (M,))."""
    kw = dict(dtype=dtype, device=device)
    if style.startswith("kalman"):
        _, kern = re_model.get_kalman_kernel(args.y, rho, r2, args.T, args.parallel,
                                             gradient=args.gradient, **kw)

        def kernel(state, delta, generator=None, noise=None):
            # The batched scalar layout runs time first: (T, M, 1).
            if noise is not None:
                noise = (noise[0].transpose(0, 1), noise[1].transpose(0, 1), noise[2])
            out = kern(KalmanSampler(x=state.x.transpose(0, 1), updated=state.updated),
                       delta, generator=generator, noise=noise)
            return GridState(x=out.x.transpose(0, 1).contiguous(), updated=out.updated,
                             rho=state.rho, r2=state.r2)
        return kernel

    if style == "csmc":
        _, kern = re_model.get_csmc_kernel(args.y, rho, r2, args.T, args.n_particles,
                                           backward=args.backward, parallel=args.parallel,
                                           gradient=args.gradient, **kw)
    elif style == "csmc-guided":
        _, kern = re_model.get_guided_csmc_kernel(args.y, rho, r2, args.T, args.n_particles,
                                                  backward=args.backward,
                                                  gradient=args.gradient, **kw)
    else:
        raise ValueError(f"unknown style {style!r}")

    def kernel(state, delta, generator=None, noise=None):
        out = kern(CSMCState(x=state.x, updated=state.updated), delta, generator=generator,
                   noise=noise)
        return GridState(x=out.x, updated=out.updated, rho=state.rho, r2=state.r2)
    return kernel


def grid_cells(grid_size):
    """The (rho, r2) of each cell, rho major: rho in linspace(0, 0.999), r2 in
    logspace(-3, 0)."""
    rhos = np.linspace(0.0, 0.999, grid_size)
    r2s = np.logspace(-3, 0, grid_size)
    return [z.ravel() for z in np.meshgrid(rhos, r2s, indexing="ij")]


def run_grid(args, *, device=None, dtype=None):
    """Run the whole grid as one batched sampler; returns (rows, res), one row
    a cell (rho, r2, err_mean_0/T, err_std_0/T, ess_0/T, rhat_0/T, acc,
    time) and the run's `RunResult` (chain axis M = grid^2 x n_chains, cell
    major)."""
    dtype = dtype or torch.get_default_dtype()
    G, C = args.grid_size, args.n_chains
    rho_grid, r2_grid = grid_cells(G)
    M = G * G * C
    kw = dict(dtype=dtype, device=device)
    RHO = torch.as_tensor(np.repeat(rho_grid, C), **kw)
    R2 = torch.as_tensor(np.repeat(r2_grid, C), **kw)

    gen = torch.Generator(device=RHO.device).manual_seed(args.seed)
    x0 = re_model.init_x(args.y, RHO, R2, args.T, args.parallel, generator=gen, **kw)
    csmc = args.style.startswith("csmc")
    upd0 = torch.zeros((M, args.T) if csmc else (M,), dtype=torch.bool, device=RHO.device)
    delta0 = torch.full((M, args.T) if csmc else (M,), args.delta_init, **kw)
    state0 = GridState(x=x0, updated=upd0, rho=RHO, r2=R2)

    kernel = make_batched_kernel(args.style, args, RHO, R2, **kw)
    cfg = cli.run_config(args, verbose=False)
    mesh, kernel_for = None, None
    devices = cli.mesh_devices(args)
    if devices is not None:
        if M % len(devices):
            raise ValueError(f"--mesh-chains {len(devices)} does not divide the flat "
                             f"cell-chain batch (grid^2 * n_chains = {M})")
        mesh = make_mesh(devices=devices, axis_names=(CHAINS,))
        n = M // len(devices)

        def kernel_for(shard, dev):  # shard s's kernel: its own M/n cells, on its device
            cells = slice(shard * n, (shard + 1) * n)
            return make_batched_kernel(args.style, args, RHO[cells].to(dev),
                                       R2[cells].to(dev), dtype=dtype, device=dev)
    res = run_sharded_chains(kernel, state0, cfg, generator=gen, collect_samples=True,
                             delta_init=delta0, mesh=mesh, kernel_for=kernel_for,
                             checkpoint_dir=getattr(args, "checkpoint_dir", None),
                             checkpoint_every=getattr(args, "checkpoint_every", 0),
                             debug_nans=getattr(args, "debug_nans", False))

    s = res.samples.reshape(G * G, C, -1, args.T)                 # cell, chain, sample, t
    acc = res.stats.accept_cum.reshape(G * G, C, -1).mean((1, 2)).cpu().numpy()
    rows = []
    for ci in range(G * G):
        rho, r2 = float(rho_grid[ci]), float(r2_grid[ci])
        (m0c, v0c), (mTc, vTc) = re_model.conditional_moments(args.y, rho, r2, args.T)
        x0s, xTs = s[ci, :, :, 0].T, s[ci, :, :, -1].T             # (n, C)
        ess_0 = float(sum(effective_sample_size(x0s[:, c]) for c in range(C)))
        ess_T = float(sum(effective_sample_size(xTs[:, c]) for c in range(C)))
        rhat_0 = float(potential_scale_reduction(x0s.T)) if C >= 2 else float("nan")
        rhat_T = float(potential_scale_reduction(xTs.T)) if C >= 2 else float("nan")
        rows.append(dict(
            rho=rho, r2=r2,
            err_mean_0=(x0s.mean() - m0c) ** 2 / v0c,
            err_std_0=(x0s.std() - np.sqrt(v0c)) / np.sqrt(v0c),
            err_mean_T=(xTs.mean() - mTc) ** 2 / vTc,
            err_std_T=(xTs.std() - np.sqrt(vTc)) / np.sqrt(vTc),
            ess_0=ess_0, ess_T=ess_T, rhat_0=rhat_0, rhat_T=rhat_T,
            acc=float(acc[ci]), time=res.sampling_time,
        ))
    return rows, res


def write_rows(path, rows):
    """The per-cell rows as CSV (a header row, then one row a cell)."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    p = cli.base_parser("Rare-event experiment")
    p.add_argument("--T", type=int, default=2)
    p.add_argument("--y", type=float, default=5.0)
    p.add_argument("--grid-size", type=int, default=10)
    p.add_argument("--figures-dir", type=str, default=None,
                   help="write heatmap figure + summary CSV here")
    p.set_defaults(n_chains=8)
    args = p.parse_args(argv)
    backend = cli.apply_backend(args)

    rows, res = run_grid(args, device=backend.device, dtype=backend.dtype)
    for r in rows:
        print(f"rho={r['rho']:.2f} r2={r['r2']:.3g}: acc={r['acc']:.2f} "
              f"ESS_T={r['ess_T']:.0f} errT={r['err_mean_T']:.3g}", flush=True)
    M = len(rows) * args.n_chains
    print(f"whole-sweep sampling time: {rows[0]['time']:.1f}s "
          f"({len(rows)} cells x {args.n_chains} chains, one batched sampler; "
          f"{M * args.n_samples / rows[0]['time']:.1f} samples/s)")

    if args.out:
        write_rows(args.out, rows)
        print(f"saved grid results to {args.out}")
    if args.figures_dir:
        from .figures import rare_event_heatmaps
        rare_event_heatmaps(rows, args.figures_dir)
        print(f"wrote heatmaps to {args.figures_dir}")
    return rows


if __name__ == "__main__":
    main()
