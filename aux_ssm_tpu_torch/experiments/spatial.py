"""Spatio-temporal Student-t experiment driver (counterpart of
`aux_ssm_tpu/experiments/spatial.py`; default T=1024 on an 8x8 grid, so
B = 64 components).

    python -m aux_ssm_tpu_torch.experiments.spatial --style kalman-2 --T 1024 --D 8
    python -m aux_ssm_tpu_torch.experiments.spatial --style csmc-guided --platform cpu --T 12 --D 3

Runs on the card unless `--platform cpu`. The kalman styles run the batched
scalar layout (two scalar filter scans and one scalar affine scan a step);
csmc and csmc-guided carry a (T,) delta. With `--n-chains C`, every style
under any options runs all C chains as one batched step (the kalman styles'
C B columns in one layout). Saves the JAX driver's .npz keys:
mean_x, var_x, ejsd, delta, xs_true, ys, sampling_time.

The data come from `np.random.default_rng(--seed)`, the JAX driver's own
simulation draw for draw, so `xs_true` and `ys` equal the JAX driver's for
the same seed. The start (`init_x_fn`, seed + 1) and the chain (seed + 2)
draw from `torch.Generator`s on the run's device.

`--batch-sharded [n]` (the kalman styles, one chain) puts the B components
over a `batch` mesh (`parallel/batch.py`): every card, or n shards (n cards,
or n CPU shards under `--platform cpu`). Each shard runs the proposal
filters and draw of its B/n columns; the gradient factory and the target,
which read the whole grid, run on the whole trajectory.
"""
import numpy as np
import torch

from ..models import spatial as sp
from ..native.precision import precision_stencil
from . import cli

SIGMA_X, TAU, R_Y, NU = 0.3, -0.25, 1.0, 4.0


def build_kernel(style, ys, args):
    """(init, kernel), and whether the style is a cSMC one ((T,) delta).
    `init` is one chain's; with `--n-chains C > 1` the kernel is the one
    over the chain axis (one batched step of all C chains, marked
    `chain_axis`), under any of the style's options."""
    common = (ys, SIGMA_X, NU, TAU, R_Y, args.D)
    chains = getattr(args, "n_chains", 1) > 1
    if style in ("kalman-1", "kalman-2"):
        order = 1 if style == "kalman-1" else 2

        def build(c):
            return sp.get_kalman_kernel(*common, parallel=args.parallel, order=order, chains=c)
    elif style == "csmc":
        def build(c):
            return sp.get_csmc_kernel(*common, args.n_particles, backward=args.backward,
                                      parallel=args.parallel, gradient=args.gradient,
                                      resampling=args.resampling, chains=c)
    elif style == "csmc-guided":
        def build(c):
            return sp.get_guided_csmc_kernel(*common, args.n_particles, backward=args.backward,
                                             gradient=args.gradient, resampling=args.resampling,
                                             chains=c)
    else:
        raise ValueError(f"unknown style {style!r}")
    init, kernel = build(False)
    return (init, build(True)[1] if chains else kernel), style.startswith("csmc")


def batch_mesh(args):
    """The `batch` mesh of `--batch-sharded [n]`: n shards
    (`cli.shard_devices`), or every card without n."""
    from ..parallel.mesh import BATCH, make_mesh
    n = args.batch_sharded
    if n > 0:
        return make_mesh(devices=cli.shard_devices(n, args.platform, "--batch-sharded"),
                         axis_names=(BATCH,))
    if args.platform == "cpu":
        raise ValueError("--batch-sharded on the CPU needs a shard count (--batch-sharded n)")
    return make_mesh(axis_names=(BATCH,))


def batch_sharded(kernel, args, is_csmc):
    """The kernel with its components over `batch_mesh(args)`; the cSMC
    styles and several chains raise, as in the JAX driver."""
    from ..parallel.batch import batch_sharded_kernel
    if is_csmc:
        raise ValueError("--batch-sharded applies to the kalman styles (batched (T, B, 1, 1) "
                         "layout) only")
    if getattr(args, "n_chains", 1) > 1:
        raise ValueError("--batch-sharded and --n-chains > 1 shard different axes over the "
                         "same devices; pick one")
    return batch_sharded_kernel(kernel, batch_mesh(args))


def main(argv=None):
    p = cli.base_parser("Spatio-temporal Student-t experiment")
    p.add_argument("--T", type=int, default=1024)
    p.add_argument("--D", type=int, default=8, help="grid side; state dim = D^2")
    p.add_argument("--batch-sharded", type=int, nargs="?", const=-1, default=0,
                   help="shard the B = D^2 component axis over every card, or over n shards "
                        "(kalman styles only)")
    args = p.parse_args(argv)
    backend = cli.apply_backend(args)
    device = backend.device

    xs_true, ys64 = sp.get_data(np.random.default_rng(args.seed), SIGMA_X, R_Y, TAU, NU,
                                args.D, args.T, device="cpu")
    ys = ys64.to(dtype=backend.dtype, device=device)
    stencil = torch.as_tensor(precision_stencil(TAU, R_Y), dtype=ys.dtype, device=device)
    x0 = sp.init_x_fn(ys, SIGMA_X, NU, stencil, args.D, max(args.n_particles, 32),
                      generator=torch.Generator(device=device).manual_seed(args.seed + 1))

    (init, kernel), is_csmc = build_kernel(args.style, ys, args)
    if args.batch_sharded:
        kernel = batch_sharded(kernel, args, is_csmc)
    state = init(x0)

    delta0 = args.delta_init * (torch.ones(args.T, dtype=ys.dtype, device=device)
                                if is_csmc else 1.0)
    cfg = cli.run_config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    res, diag = cli.run_maybe_sharded(
        gen, kernel, state, cfg, args, collect_samples=False, delta_init=delta0,
        kernel_for=lambda shard, dev: build_kernel(args.style, ys.to(dev), args)[0][1])
    stats = diag["stats"] if diag else res.stats

    print(f"style={args.style} T={args.T} D={args.D} (d={args.D ** 2}): "
          f"time={res.sampling_time:.2f}s "
          f"({cfg.n_samples / res.sampling_time:.1f} samples/s), "
          f"acc={float(stats.accept_cum.mean()):.3f}, "
          f"mean EJSD={float(stats.ejsd.mean()):.4g}"
          f"{cli.chain_summary(res, diag, cfg)}")

    cli.save_results(args.out, mean_x=stats.mean_x, var_x=stats.mean_x2 - stats.mean_x ** 2,
                     ejsd=stats.ejsd, delta=res.delta, xs_true=xs_true, ys=ys64,
                     sampling_time=res.sampling_time)
    return res


if __name__ == "__main__":
    main()
