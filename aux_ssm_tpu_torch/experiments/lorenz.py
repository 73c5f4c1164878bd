"""Lorenz-63 parameter-learning driver (counterpart of
`aux_ssm_tpu/experiments/lorenz.py`): Gibbs alternation of the auxiliary
Kalman trajectory kernel with the conjugate theta draw.

Synthetic data by default. `--data mider` runs the Mider et al. dataset
shipped with the JAX package (read in place as data) with the reference's
smoothing-frequency semantics: grid dt = freq * 1e-4 over t in [0, 2],
observations every 0.01, P0 = diag(400, 20, 20), sig_y = sqrt(5),
sigma_theta = sqrt(1000), theta_0 = (5, 15, 6). `--data PATH` loads any
(t, y2, y3) CSV on the synthetic mode's grid arguments.

    python -m aux_ssm_tpu_torch.experiments.lorenz --data mider --freq 4
    python -m aux_ssm_tpu_torch.experiments.lorenz --freq 4 --platform cpu

Runs on the card unless `--platform cpu`; `--n-chains C` runs all C chains
as one batched Gibbs step (`lorenz.get_gibbs_kernel(..., chains=True)`).
Saves the JAX driver's .npz keys:
mean_x, ejsd, theta, theta_samples, delta, sampling_time, freq.
"""
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..models import lorenz
from . import cli

M0 = (1.5, -1.5, 25.0)
THETA_TRUE = (10.0, 28.0, 8.0 / 3.0)
SIGMA_X, SIG_Y = 3.0, 0.5
MIDER_DATA = (Path(__file__).resolve().parents[2] / "aux_ssm_tpu" / "experiments" / "data"
              / "lorenz" / "data.csv")


class Problem(NamedTuple):
    """A Lorenz run's model and start on one dtype and device."""
    ys: torch.Tensor   # (T, 2), NaN off the observation steps
    Hs: torch.Tensor   # (T, 2, 3)
    Rs: torch.Tensor   # (T, 2, 2)
    cs: torch.Tensor   # (T, 2)
    m0: torch.Tensor
    P0: torch.Tensor
    x0: torch.Tensor   # (T, 3), `lorenz.init_x_fn`'s interpolation
    theta0: torch.Tensor
    dt: float
    sigma_theta: float


def make_problem(data, obs_idx, n_steps, dt, P0, sig_y, theta0, sigma_theta, kw):
    """The `Problem` of data rows (t, y2, y3) observed at grid steps `obs_idx`
    of an `n_steps` grid, on the dtype and device of `kw`."""
    ys, Hs, Rs, cs = (torch.as_tensor(z, **kw) for z in
                      lorenz.observations_model(data, sig_y, n_steps, obs_idx=obs_idx))
    return Problem(ys, Hs, Rs, cs, torch.as_tensor(M0, **kw), torch.as_tensor(P0, **kw),
                   lorenz.init_x_fn(data, n_steps, **kw), torch.as_tensor(theta0, **kw), dt,
                   sigma_theta)


def mider_problem(freq, *, sigma_theta=None, dtype=torch.float32, device=None):
    """The Mider data on the grid dt = freq * 1e-4 (T = 2 / dt + 1) with the
    reference's priors and start. Observation times go to the nearest grid
    step (exact for freq dividing 100; at freq 8 rounding keeps every one)."""
    data = np.loadtxt(MIDER_DATA, delimiter=",", skiprows=1)
    dt = freq * 1e-4
    n_steps = int(round(float(data[-1, 0]) / dt)) + 1
    obs_idx = np.rint(data[:, 0] / dt).astype(np.int64)
    return make_problem(data, obs_idx, n_steps, dt, np.diag([400.0, 20.0, 20.0]), 5.0 ** 0.5,
                    [5.0, 15.0, 6.0], 1e3 ** 0.5 if sigma_theta is None else sigma_theta,
                    dict(dtype=dtype, device=resolve(device)))


def main(argv=None):
    p = cli.base_parser("Stochastic Lorenz parameter learning")
    p.add_argument("--n-steps", type=int, default=512)
    p.add_argument("--freq", type=int, default=4,
                   help="synthetic: observe every k steps; mider: smoothing "
                        "dt = freq * 1e-4 (reference semantics)")
    p.add_argument("--dt", type=float, default=0.02)
    p.add_argument("--sigma-theta", type=float, default=None,
                   help="theta prior std (default 100, or sqrt(1000) with "
                        "--data mider)")
    p.add_argument("--data", type=str, default=None,
                   help="'mider' for the shipped reference dataset, or a CSV "
                        "path with columns t, y2, y3")
    args = p.parse_args(argv)
    backend = cli.apply_backend(args)
    kw = dict(dtype=backend.dtype, device=backend.device)
    sigma_theta = 100.0 if args.sigma_theta is None else args.sigma_theta

    if args.data == "mider":
        prob = mider_problem(args.freq, sigma_theta=args.sigma_theta, **kw)
    else:
        n_steps, dt = args.n_steps, args.dt
        if args.data:
            data = np.loadtxt(args.data, delimiter=",", skiprows=1)
            obs_idx = np.rint(data[:, 0] / dt).astype(np.int64)
        else:
            xs = lorenz.sample_trajectory(M0, np.eye(3), THETA_TRUE, SIGMA_X, dt, n_steps,
                                          generator=torch.Generator().manual_seed(args.seed),
                                          device="cpu").numpy()
            obs_idx = np.arange(0, n_steps, args.freq)
            obs = xs[obs_idx, 1:] + SIG_Y * np.random.default_rng(args.seed).standard_normal(
                (len(obs_idx), 2))
            data = np.column_stack([obs_idx * dt, obs])
        prob = make_problem(data, obs_idx, n_steps, dt, np.eye(3), SIG_Y, [0.0, 0.0, 0.0],
                        sigma_theta, kw)

    model = (prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0, SIGMA_X, prob.dt,
             prob.sigma_theta, args.parallel)
    init, kernel = lorenz.get_gibbs_kernel(*model)
    if args.n_chains > 1:  # the kernel over the chain axis; the start is one chain's
        kernel = lorenz.get_gibbs_kernel(*model, chains=True)[1]
    state = init(prob.x0, prob.theta0)

    cfg = cli.run_config(args)
    # The theta trace is small (n_samples x 3): always collected, as the JAX
    # driver does, so a run's .npz carries theta_samples.
    gen = torch.Generator(device=kw["device"]).manual_seed(args.seed + 1)
    def kernel_for(shard, device):  # a chains mesh shard's kernel, on its device
        moved = tuple(z.to(device) if isinstance(z, torch.Tensor) else z for z in model)
        return lorenz.get_gibbs_kernel(*moved, chains=True)[1]

    res, diag = cli.run_maybe_sharded(gen, kernel, state, cfg, args, collect_samples=True,
                                      collect_fn=lambda s: s.theta, kernel_for=kernel_for)
    stats = diag["stats"] if diag else res.stats

    theta = res.state.theta.cpu().numpy()
    theta_show = theta.mean(0) if diag else theta
    print(f"freq={args.freq} n_steps={prob.ys.shape[0]} dt={prob.dt:g}: "
          f"time={res.sampling_time:.2f}s "
          f"({cfg.n_samples / res.sampling_time:.1f} samples/s), "
          f"acc={float(stats.accept_cum.mean()):.3f}, "
          f"theta_final={np.round(theta_show, 3)} (true {np.asarray(THETA_TRUE)})"
          f"{cli.chain_summary(res, diag, cfg)}")

    cli.save_results(args.out, mean_x=stats.mean_x, ejsd=stats.ejsd,
                     theta=theta, theta_samples=res.samples,
                     delta=res.delta, sampling_time=res.sampling_time,
                     freq=args.freq)
    return res


if __name__ == "__main__":
    main()
