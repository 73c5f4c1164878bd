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
with per-chain statistics and delta adaptation. Device meshes (`mesh=`) are
multi-device work and raise NotImplementedError.
"""
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..experiments.runner import RunConfig, RunResult, run_chain

_MESH_TODO = ("device meshes are not ported: multi-device chains are ROADMAP.md queue 2 "
              "(parallel/mesh.py)")


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
        n = _first_leading(state)
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


def _first_leading(state):
    found = []
    _map_state(lambda z: found.append(z.shape[0]) or z, state)
    return found[0]


def run_sharded_chains(kernel: Callable, init_states, cfg: RunConfig, generator=None,
                       mesh=None, collect_samples: bool = False,
                       get_stats_x: Callable = lambda s: s.x, delta_init=None,
                       checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
                       collect_fn: Callable = None, debug_nans: bool = False) -> RunResult:
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
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    x = get_stats_x(init_states)
    n_chains = x.shape[0]
    if delta_init is None:
        delta_init = torch.full((n_chains,), cfg.delta_init, dtype=x.dtype, device=x.device)
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


def aggregate_chain_stats(stats):
    """Each statistic's mean over the chain axis."""
    return _map_state(lambda z: z.to(torch.float64 if not z.is_floating_point() else z.dtype)
                      .mean(0), stats)
