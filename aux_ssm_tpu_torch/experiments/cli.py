"""Shared CLI plumbing of the experiment drivers (counterpart of
`aux_ssm_tpu/experiments/cli.py`): the same flags and defaults.

`--n-chains` C above 1 runs C chains on one card (`parallel/chains.py`):
as one batched step where the driver's model offers a kernel over the chain
axis (marked `chain_axis`: every style of the SV, spatial and Lorenz
drivers under any options; the rare-event grid batches its own), else a
one-chain kernel chain after chain (`chains.chain_loop`); the run reports
split-R-hat. `--mesh-chains n` puts the C chains on a `chains` mesh of n
shards (`parallel/chains.py`): n cards, or n CPU shards under `--platform
cpu`; asking for more cards than the machine has raises ValueError, where
the JAX package's `jax.devices()[:n]` would run on fewer.
`--checkpoint-dir` (with `--checkpoint-every`) makes a run resumable: a
killed run started again with the same arguments goes on from its newest
checkpoint, bit for bit (`runner.run_chain`). `--debug-nans` checks the
chain after every step (`runner.check_finite`).
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


def shard_devices(n, platform, flag="--mesh-chains"):
    """The devices of n shards: n CPU shards under `--platform cpu`, else
    cards 0..n-1 (ValueError where the machine has fewer than n)."""
    if platform == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"{flag} {n} asks for {n} cards; this machine has {have}")
    return [f"cuda:{i}" for i in range(n)]


def mesh_devices(args):
    """The devices of `--mesh-chains n` (`shard_devices`), None for 0."""
    n = getattr(args, "mesh_chains", 0)
    return shard_devices(n, getattr(args, "platform", None)) if n else None


def run_maybe_sharded(generator, kernel, state, cfg, args, *, collect_samples=False,
                      delta_init=None, collect_fn=None, devices=None, kernel_for=None):
    """Single- or multi-chain dispatch shared by the experiment drivers, with
    a one-chain `state` and a one-chain `kernel` or one over the chain axis
    (marked `chain_axis`); checkpointed under `--checkpoint-dir` every
    `--checkpoint-every` iterations when given.

    `--n-chains 1`: `run_chain`; returns (res, None). `--n-chains C > 1`: the
    state and delta broadcast to a leading chain axis, a `chain_axis` kernel
    run as one batched step, any other on chain after chain
    (`chains.chain_loop`), through `run_sharded_chains`;
    returns (res, diag), `diag` the chains' mean statistics (`stats`) and
    split-R-hat (`rhat_max`, `rhat_median`): rank-normalised split-R-hat of
    at most 128 evenly spread coordinates of the collected samples, else the
    moment-based R-hat of every coordinate from the online statistics.

    A mesh: `devices` (a list, e.g. ["cuda:0"] * 4), else `--mesh-chains`'s
    (`mesh_devices`), puts C > 1 chains on a `chains` mesh of that many
    shards (S must divide C); `kernel_for(shard, device)` builds a shard's
    kernel (`parallel.chains.mesh_kernel`), needed for a shard on another
    device than the state's."""
    from ..parallel.chains import (aggregate_chain_stats, broadcast_chains, chain_loop,
                                   run_sharded_chains)
    from ..utils.ess import potential_scale_reduction, rhat_from_moments
    from ..utils.stats import variance

    from ..parallel.mesh import CHAINS, make_mesh

    n_chains = getattr(args, "n_chains", 1)
    devices = mesh_devices(args) if devices is None else devices
    mesh = None
    if devices is not None and n_chains > 1:
        if n_chains % len(devices):
            raise ValueError(f"--mesh-chains {len(devices)} does not divide --n-chains "
                             f"{n_chains}")
        mesh = make_mesh(devices=devices, axis_names=(CHAINS,))
    ckpt = dict(checkpoint_dir=getattr(args, "checkpoint_dir", None),
                checkpoint_every=getattr(args, "checkpoint_every", 0),
                debug_nans=getattr(args, "debug_nans", False))
    if n_chains <= 1:
        res = run_chain(kernel, state, cfg, generator=generator,
                        collect_samples=collect_samples, delta_init=delta_init,
                        collect_fn=collect_fn, **ckpt)
        return res, None

    x = state.x
    delta0 = torch.as_tensor(cfg.delta_init if delta_init is None else delta_init,
                             dtype=x.dtype, device=x.device)
    batched = kernel if getattr(kernel, "chain_axis", False) else chain_loop(kernel)
    res = run_sharded_chains(batched, broadcast_chains(state, n_chains), cfg,
                             generator=generator, collect_samples=collect_samples,
                             delta_init=broadcast_chains(delta0, n_chains),
                             collect_fn=collect_fn, mesh=mesh, kernel_for=kernel_for, **ckpt)
    if collect_samples and res.samples is not None and res.samples.size:
        flat = res.samples.reshape(res.samples.shape[0], res.samples.shape[1], -1)
        n_coords = flat.shape[-1]
        take = np.unique(np.linspace(0, n_coords - 1, min(128, n_coords)).astype(int))
        rhats = torch.stack([potential_scale_reduction(torch.from_numpy(
            np.ascontiguousarray(flat[:, :, i]))) for i in take])
    else:
        rhats = rhat_from_moments(res.stats.mean_x, variance(res.stats),
                                  cfg.n_samples).reshape(-1)
    rhats = rhats.detach().cpu().numpy()
    diag = dict(stats=aggregate_chain_stats(res.stats, mesh), rhat_max=float(np.max(rhats)),
                rhat_median=float(np.median(rhats)), n_chains=n_chains)
    return res, diag


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
