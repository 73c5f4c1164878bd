"""Shared CLI plumbing of the experiment drivers (counterpart of
`aux_ssm_tpu/experiments/cli.py`): the same flags and defaults.

One chain a run: `--n-chains` above 1 needs chain batching
(`parallel/chains.py`), not ported, and raises NotImplementedError.
`--checkpoint-dir` (with `--checkpoint-every`) makes a run resumable: a
killed run started again with the same arguments goes on from its newest
checkpoint, bit for bit (`runner.run_chain`).
"""
import argparse

import numpy as np
import torch

from ..config import BackendConfig, ExperimentConfig, MeshConfig, SamplerConfig
from .runner import RunConfig, run_chain


def base_parser(description):
    p = argparse.ArgumentParser(description)
    p.add_argument("--style", type=str, default="kalman-1",
                   help="kalman-1 | kalman-2 | csmc | csmc-guided")
    p.add_argument("--parallel", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--gradient", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--backward", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--N", dest="n_particles", type=int, default=25)
    p.add_argument("--resampling", type=str, default="multinomial")

    p.add_argument("--n-samples", type=int, default=10_000)
    p.add_argument("--burnin", type=int, default=2_500)
    p.add_argument("--target-alpha", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--beta", type=float, default=0.05)
    p.add_argument("--delta-init", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=42)

    p.add_argument("--precision", type=str, default="single")
    p.add_argument("--platform", type=str, default=None,
                   help="None or gpu: the card; cpu")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--verbose", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--out", type=str, default=None, help="output .npz path")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="persist/resume chain state under this directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint period in iterations (0 = phase ends only)")
    p.add_argument("--n-chains", type=int, default=1,
                   help="independent chains, sharded over the mesh 'chains' axis")
    p.add_argument("--mesh-chains", type=int, default=0,
                   help="devices on the 'chains' mesh axis (0 = no mesh)")
    return p


def experiment_config(args, **overrides):
    """The typed `ExperimentConfig` of parsed arguments, as the JAX
    package's `experiment_config` builds it."""
    mesh_n = getattr(args, "mesh_chains", 0)
    kw = dict(
        backend=BackendConfig(precision=args.precision, platform=args.platform,
                              debug=args.debug, debug_nans=args.debug_nans),
        mesh=MeshConfig(axis_names=("chains",), axis_sizes=(mesh_n,) if mesh_n else None),
        sampler=SamplerConfig(style=args.style, parallel=args.parallel,
                              gradient=args.gradient, backward=args.backward,
                              n_particles=args.n_particles, resampling=args.resampling),
        run=run_config(args),
        seed=args.seed,
        n_chains=getattr(args, "n_chains", 1),
        checkpoint_dir=getattr(args, "checkpoint_dir", None),
        checkpoint_every=getattr(args, "checkpoint_every", 0),
    )
    kw.update(overrides)
    return ExperimentConfig(**kw)


def apply_backend(args):
    """Apply the backend flags; returns the `BackendConfig` (its `dtype` and
    `device` are the run's)."""
    return BackendConfig(precision=args.precision, platform=args.platform,
                         debug=args.debug, debug_nans=args.debug_nans).apply()


def run_config(args, **overrides):
    kw = dict(
        n_samples=args.n_samples, burnin=args.burnin,
        target_alpha=args.target_alpha, delta_init=args.delta_init,
        learning_rate=args.lr, beta=args.beta, verbose=args.verbose,
    )
    kw.update(overrides)
    return RunConfig(**kw)


def run_maybe_sharded(generator, kernel, state, cfg, args, *, collect_samples=False,
                      delta_init=None, collect_fn=None):
    """One chain through `run_chain`, checkpointed under `--checkpoint-dir`
    every `--checkpoint-every` iterations when given; returns (res, None),
    the None standing for the cross-chain diagnostics of several chains."""
    n_chains = getattr(args, "n_chains", 1)
    if n_chains > 1:
        raise NotImplementedError(f"--n-chains {n_chains}: chain batching is not ported "
                                  "(it needs parallel/chains.py)")
    res = run_chain(kernel, state, cfg, generator=generator, collect_samples=collect_samples,
                    delta_init=delta_init, checkpoint_dir=getattr(args, "checkpoint_dir", None),
                    checkpoint_every=getattr(args, "checkpoint_every", 0), collect_fn=collect_fn)
    return res, None


def chain_summary(res, diag, cfg):
    """The throughput and R-hat suffix of a several-chain run: empty for one
    chain."""
    if diag is None:
        return ""
    total = diag["n_chains"] * cfg.n_samples
    return (f", {diag['n_chains']} chains ({total / res.sampling_time:.1f} "
            f"samples/s total), Rhat max={diag['rhat_max']:.3f} "
            f"median={diag['rhat_median']:.3f}")


def save_results(path, **arrays):
    """Save tensors and arrays (moved to the host) as one .npz."""
    if path:
        np.savez(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v) for k, v in arrays.items()})
        print(f"saved results to {path}")
