"""Stochastic-volatility experiment driver (counterpart of
`aux_ssm_tpu/experiments/sv.py`; default T=250, D=30, N=25, 2500 burn-in
and 10000 sampling iterations, target update rate 0.5).

    python -m aux_ssm_tpu_torch.experiments.sv --style kalman-2 --T 250 --D 30
    python -m aux_ssm_tpu_torch.experiments.sv --style csmc --platform cpu --T 16 --D 2

Runs on the card unless `--platform cpu`. Styles: kalman-1 and kalman-2
(the auxiliary Kalman sampler; at D = 30 the MH kernels' D = 32 instance),
csmc (independent proposals; parallel-in-time by default, `--no-parallel`
for the sequential sweep) and csmc-guided (the block-lane sweep). With
`--n-chains C`, every style under any options runs all C chains as one
batched step. Saves the JAX driver's .npz keys: samples_mean, samples_std, ejsd, delta, xs_true, ys,
sampling_time.

The random streams are the port's own: the data come from a CPU
`torch.Generator` seeded with `--seed` (`get_data`), the start from one on
the run's device seeded with seed + 1 (`init_x_fn`), the chain from another
seeded with seed + 2. So for the same seed the data differ from the JAX
driver's, which draws with `jax.random`. With `--checkpoint-dir` a killed
run started again with the same arguments resumes bit for bit.
"""
import torch

from ..models import stochastic_volatility as sv
from ..utils.analysis import ejsd_per_time, ess_summary
from . import cli

NU, PHI, TAU, RHO = 0.0, 0.9, 2.0, 0.25


def build_kernel(style, ys, args):
    """(init, kernel): `init` one chain's; with `--n-chains C > 1` the
    kernel is the one over the chain axis (one batched step of all C chains,
    marked `chain_axis`), under any of the style's options."""
    chains = getattr(args, "n_chains", 1) > 1
    if style in ("kalman-1", "kalman-2"):
        order = 1 if style == "kalman-1" else 2

        def build(c):
            return sv.get_kalman_kernel(ys, NU, PHI, TAU, RHO, args.parallel, order=order,
                                        chains=c)
    elif style == "csmc":
        def build(c):
            return sv.get_csmc_kernel(ys, NU, PHI, TAU, RHO, args.n_particles,
                                      backward=args.backward, parallel=args.parallel,
                                      gradient=args.gradient, resampling=args.resampling,
                                      chains=c)
    elif style == "csmc-guided":
        def build(c):
            return sv.get_guided_csmc_kernel(ys, NU, PHI, TAU, RHO, args.n_particles,
                                             backward=args.backward, gradient=args.gradient,
                                             resampling=args.resampling, chains=c)
    else:
        raise ValueError(f"unknown style {style!r}")
    init, kernel = build(False)
    return init, build(True)[1] if chains else kernel


def main(argv=None):
    p = cli.base_parser("Stochastic-volatility experiment")
    p.add_argument("--T", type=int, default=250)
    p.add_argument("--D", type=int, default=30)
    args = p.parse_args(argv)
    cfg_x = cli.experiment_config(args)
    backend = cfg_x.backend.apply()
    device = backend.device

    xs_true, ys = sv.get_data(NU, PHI, TAU, RHO, args.D, args.T,
                              generator=torch.Generator().manual_seed(args.seed),
                              dtype=backend.dtype, device=device)
    x0 = sv.init_x_fn(ys, NU, PHI, TAU, RHO, max(args.n_particles, 32),
                      generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    init, kernel = build_kernel(args.style, ys, args)
    state = init(x0)

    is_csmc = args.style.startswith("csmc")
    delta0 = args.delta_init * (torch.ones(args.T, dtype=ys.dtype, device=device)
                                if is_csmc else 1.0)
    cfg = cfg_x.run
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    res, diag = cli.run_maybe_sharded(
        gen, kernel, state, cfg, args, collect_samples=True, delta_init=delta0,
        kernel_for=lambda shard, dev: build_kernel(args.style, ys.to(dev), args)[1])
    stats = diag["stats"] if diag else res.stats
    # Several chains: the coordinates pool each chain's samples.
    samples = res.samples.reshape(-1, *res.samples.shape[-2:]) if diag else res.samples

    ess = ess_summary(samples)
    mean_ejsd = float(stats.ejsd.mean())
    efficiency = ejsd_per_time(mean_ejsd, res.sampling_time, cfg.n_samples)
    print(f"style={args.style} T={args.T} D={args.D}: "
          f"time={res.sampling_time:.2f}s "
          f"({cfg.n_samples / res.sampling_time:.1f} samples/s), "
          f"acc={float(stats.accept_cum.mean()):.3f}, "
          f"mean EJSD={mean_ejsd:.4g}, "
          f"EJSD/time-per-iter={float(efficiency):.4g}, "
          f"ESS(quartiles)={[round(v, 1) for v in ess.values()]}"
          f"{cli.chain_summary(res, diag, cfg)}")

    cli.save_results(args.out, samples_mean=samples.mean(0), samples_std=samples.std(0),
                     ejsd=stats.ejsd, delta=res.delta, xs_true=xs_true, ys=ys,
                     sampling_time=res.sampling_time)
    return res


if __name__ == "__main__":
    main()
