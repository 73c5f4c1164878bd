"""Independent MCMC chains on a leading chain axis, on one card (counterpart
of `aux_ssm_tpu/parallel/chains.py`, without its device mesh).

A kernel over the chain axis takes a state whose every tensor has a leading
axis of C chains, a delta of shape (C,) or (C, T), and returns the C chains'
next states. Two kinds:

  - a batched kernel: the model carries the chain axis through its own
    tensors and kernels, so one step is one set of launches whatever C is:
    the rare-event grid (`experiments/rare_event.py`); the auxiliary-Kalman
    styles of the SV model, the Lorenz Gibbs sampler and the flagship LGSSM,
    whose six MH kernels take the chain axis (`kernels.kalman.chain_major`);
    every style of the SV and spatial drivers under any options: SV csmc
    (PIT or sequential) and csmc-guided, spatial kalman-1/2 (C B columns of
    the batched scalar layout), csmc and csmc-guided (the block-lane, lane
    and factor sweeps and the stitching kernels on either PIT route take the
    chain axis; the generic step loops, ancestor scanning and systematic
    resampling run it as a leading axis in plain torch); theta-logistic
    PGAS. Such a kernel is marked `chain_axis` where a driver picks it. It draws the noise of all C
    chains in one call from one `torch.Generator`: the JAX package's
    per-chain `chain_keys` (`fold_in(key, c)`) have no counterpart, and a
    chain's draws depend on C and on its place in the batch;
  - `chain_loop(kernel)`: a one-chain kernel run on chain after chain, for a
    kernel without the chain axis (a user's own; every model builder of the
    port offers `chains=True`), and as the reference the batched kernels are
    held to. It launches the one-chain kernels C times a step, so a step
    costs C one-chain steps of host time and launches.

`run_sharded_chains` runs such a kernel through `runner.run_chain`'s loop,
with per-chain statistics and delta adaptation.

With `mesh=` (a `chains` axis of S shards, `parallel/mesh.py`), shard s runs
the kernel on its C/S chains on its own device, and the chains come back
together after each step (`collectives.gather`: a concatenation on one
card, an all-gather across processes), so the loop, the statistics and the
checkpoints see all C chains as without a mesh. At S = 1 the run is bit for
bit the one without a mesh. At S > 1 shard s draws from a generator of its
own on its device, seeded from the run generator's seed and s
(`shard_seed`), so shard s's chains are those of a one-process batched run
of C/S chains with that generator. This is where the port departs from the
JAX package, whose per-chain keys (`chain_keys`, `fold_in(key, c)`) make a
chain's draws independent of the layout: the port has no such keys, and a
chain's draws depend on its shard and its place there.
"""
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..experiments.runner import RunConfig, RunResult, run_chain
from .mesh import CHAINS


def _map_state(fn, state):
    """`fn` on every tensor of a state (a dataclass or a tensor); None kept."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: _map_state(fn, getattr(state, f.name))
            for f in dataclasses.fields(state) if f.init})
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(fn, z) for z in state)
    if isinstance(state, dict):
        return {k: _map_state(fn, v) for k, v in state.items()}
    return state


def _stack_states(states):
    """One state with a leading chain axis from C one-chain states."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack_states([getattr(s, f.name) for s in states])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_states(list(z)) for z in zip(*states))
    if isinstance(first, dict):
        return {k: _stack_states([s[k] for s in states]) for k in first}
    return first


def broadcast_chains(tree, n_chains):
    """`tree` (a state or a tensor) copied onto a leading axis of `n_chains`
    chains."""
    return _map_state(lambda z: z.expand((n_chains,) + tuple(z.shape)).clone(), tree)


def chain_loop(kernel: Callable) -> Callable:
    """A kernel over the chain axis from a one-chain kernel `kernel(state,
    delta, generator=None, noise=None)`: chain c's state, delta and noise
    (each tensor's slice c) through `kernel`, chain after chain, the results
    stacked. Chain c draws from `generator` after chains 0..c-1."""

    def batched(state, delta, generator=None, noise=None):
        n = _first(state).shape[0]
        delta = torch.as_tensor(delta)
        out = []
        for c in range(n):
            one = _map_state(lambda z: z[c], state)
            kw = {} if noise is None else {"noise": _map_state(lambda z: z[c], noise)}
            out.append(kernel(one, delta[c] if delta.dim() else delta, generator=generator,
                              **kw))
        return _stack_states(out)

    batched.one_chain = kernel
    return batched


def _first(state):
    """The first tensor of a state."""
    found = []
    _map_state(lambda z: found.append(z) or z, state)
    return found[0]


def shard_chains(mesh, tree):
    """This process's shards of `tree`'s leading (chain) axis over the
    `chains` mesh axis: a list, one tree a shard, on its device."""
    from .mesh import chain_sharding
    return chain_sharding(mesh).place(tree)


def shard_seed(seed, shard):
    """The seed of shard `shard`'s generator in a run seeded `seed`."""
    return int(np.random.SeedSequence([int(seed), int(shard)]).generate_state(1, np.uint64)[0]
               % (2 ** 63))


class ShardGenerators:
    """The generators of a `chains` mesh's local shards: the run's own at S
    = 1, else one a shard on its device, seeded `shard_seed(generator's
    seed, s)`. `get_state` / `set_state` save and restore them together, so
    `run_chain`'s checkpoints hold every shard's."""

    def __init__(self, mesh, generator, axis=CHAINS):
        if generator is None:
            raise ValueError("a chains mesh needs the run's generator: its seed seeds the "
                             "shards'")
        if mesh.shape[axis] == 1:
            self.shards = [generator]
        else:
            seed = generator.initial_seed()
            self.shards = [torch.Generator(device=d).manual_seed(shard_seed(seed, s))
                           for s, d in zip(mesh.local_shards(axis), mesh.local_devices(axis))]

    def get_state(self):
        return torch.cat([g.get_state() for g in self.shards])

    def set_state(self, state):
        at = 0
        for g in self.shards:
            n = g.get_state().numel()
            g.set_state(state[at:at + n].clone())
            at += n


def mesh_kernel(kernel: Callable, mesh, generators: ShardGenerators, axis=CHAINS,
                kernel_for: Callable = None) -> Callable:
    """A kernel over the chain axis that runs `kernel` on each local shard's
    C/S chains, on the shard's device and with its generator
    (`generators`), and gathers the chains back onto the state's device.
    `kernel_for(shard, device)`, where given, builds shard `shard`'s kernel
    instead (once): for a shard on another device than the state's (a
    kernel holds its model's tensors on one device), or a kernel whose model
    has a value a chain (the rare-event grid's cells)."""
    from . import collectives as col

    kernels = {}

    def on(shard, device, home):
        if kernel_for is None:
            if device != home:
                raise ValueError(f"a shard on {device}, the chains on {home}: pass "
                                 "kernel_for(shard, device) to build the kernel there")
            return kernel
        if shard not in kernels:
            kernels[shard] = kernel_for(shard, device)
        return kernels[shard]

    def sharded(state, delta, generator=None, noise=None):
        del generator  # each shard draws from its own
        home = _first(state).device
        states = shard_chains(mesh, state)
        deltas = col.split(mesh, torch.as_tensor(delta, device=home), 0, axis)
        noises = [None] * len(states) if noise is None else shard_chains(mesh, noise)
        outs = []
        for s, dev, st, dl, nz, gen in zip(mesh.local_shards(axis), mesh.local_devices(axis),
                                           states, deltas, noises, generators.shards):
            kw = {} if nz is None else {"noise": nz}
            outs.append(on(s, dev, home)(st, dl, generator=gen, **kw))
        return _gather_states(mesh, outs, axis, home)

    sharded.chain_axis = True
    return sharded


def _gather_states(mesh, outs, axis, home):
    """One state of every chain, on `home`, from the local shards' states."""
    from . import collectives as col
    leaves = [[] for _ in outs]
    for i, out in enumerate(outs):
        _map_state(lambda z, i=i: leaves[i].append(z) or z, out)
    whole = iter([col.gather(mesh, list(zs), 0, axis).to(home) for zs in zip(*leaves)])
    return _map_state(lambda z: next(whole), outs[0])


def run_sharded_chains(kernel: Callable, init_states, cfg: RunConfig, generator=None,
                       mesh=None, collect_samples: bool = False,
                       get_stats_x: Callable = lambda s: s.x, delta_init=None,
                       checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
                       collect_fn: Callable = None, debug_nans: bool = False,
                       kernel_for: Callable = None) -> RunResult:
    """Run C independent chains (the leading axis of `init_states`) through
    burn-in and sampling with `kernel`, a kernel over the chain axis.

    Every output keeps the leading chain axis: the state, `delta`, the
    statistics (`step` (C,)) and `samples`, a host array (C, n_samples,
    ...). `sampling_time` excludes burn-in. Each chain's delta (default
    cfg.delta_init for every chain; `delta_init` (C,) or (C, T)) adapts on
    that chain's own rate, elementwise. With `checkpoint_dir`, the run saves
    and resumes as `run_chain` does, bit for bit; `generator` must then be
    given. With `debug_nans`, a non-finite state or delta raises
    FloatingPointError naming the iteration and the chain (`run_chain`).
    Aggregate the statistics with `aggregate_chain_stats`.

    With `mesh`, C chains over its `chains` axis of S shards (S divides C):
    `mesh_kernel` (the module docstring), `generator` required; a shard on
    another device than `init_states` runs `kernel_for(device)`. Every
    process passes all C chains and gets all C back.
    """
    x = get_stats_x(init_states)
    n_chains = x.shape[0]
    if delta_init is None:
        delta_init = torch.full((n_chains,), cfg.delta_init, dtype=x.dtype, device=x.device)
    if mesh is not None:
        if n_chains % mesh.shape[CHAINS]:
            raise ValueError(f"{mesh.shape[CHAINS]} shards of the chains mesh do not divide "
                             f"{n_chains} chains")
        generator = ShardGenerators(mesh, generator)
        kernel = mesh_kernel(kernel, mesh, generator, kernel_for=kernel_for)
    res = run_chain(kernel, init_states, cfg, generator=generator,
                    collect_samples=collect_samples, get_stats_x=get_stats_x,
                    delta_init=delta_init, checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, collect_fn=collect_fn,
                    n_chains=n_chains, debug_nans=debug_nans)
    samples = res.samples
    if collect_samples:
        samples = (np.moveaxis(samples, 0, 1) if samples.ndim > 1
                   else np.zeros((n_chains, 0), dtype=np.float32))
    return dataclasses.replace(res, samples=samples)


def aggregate_chain_stats(stats, mesh=None):
    """Each statistic's mean over the chain axis; with `mesh`, each shard's
    sum over its chains, added across the `chains` shards by `psum`."""
    def mean(z):
        z = z.to(torch.float64 if not z.is_floating_point() else z.dtype)
        if mesh is None:
            return z.mean(0)
        from . import collectives as col
        parts = col.split(mesh, z, 0, CHAINS)
        return col.psum(mesh, [p.sum(0) for p in parts], CHAINS)[0].to(z.device) / z.shape[0]
    return _map_state(mean, stats)
