"""Generic MCMC experiment loop (counterpart of
`aux_ssm_tpu/experiments/runner.py`): burn-in with delta adaptation
(linearly decaying learning rate, acceptance-window EMA), then a frozen-delta
sampling phase with online EJSD/moment statistics.

The loop runs on the host, one kernel call per iteration, and never reads a
device value back except to print progress (`verbose`), to collect samples
or to check the state (`debug_nans`). It runs in segments: of `checkpoint_every` iterations when
checkpointing, of at most COLLECT_SEGMENT while collecting samples, else one
a phase. Segment boundaries do not change the chain. Each sampling segment
is timed on the host clock between two device fences
(`utils.profiling.fence`); `sampling_time` is their sum, and the copies of
collected samples to the host and the checkpoint writes fall outside it.

Checkpoint/resume: with `checkpoint_dir`, the loop saves its whole state
(phase, iteration, sampler state, delta, statistics, the samples collected
so far, the sampling time so far and the random generator's state) after
every segment (`utils/checkpoint.py`), and a later call with the same
arguments resumes from the newest checkpoint. The kernels draw from one
stateful `torch.Generator` (the JAX loop derives each iteration's key by
`fold_in(phase_key, i)` instead), so the generator's state is saved and
restored with the chain and nothing else draws from it between segments: a
run killed anywhere resumes bit for bit. A checkpointed run therefore needs
a generator of its own; the default generator is shared with every other
caller.
"""
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels.adaptation import delta_adaptation
from ..utils.profiling import fence as _fence
from ..utils.stats import OnlineStats, init_stats, update_stats

_BURNIN_PHASE, _SAMPLE_PHASE = 0, 1
# Collected samples wait on the device for at most this many iterations
# before they are copied into the host buffer (outside the timer).
COLLECT_SEGMENT = 256
# Checkpoints kept on disk: the newest and the one before it.
KEEP_CHECKPOINTS = 2


@dataclass(frozen=True)
class RunConfig:
    """Schedule and adaptation configuration of one run."""
    n_samples: int = 1000
    burnin: int = 100
    target_alpha: float = 0.5
    delta_init: float = 1e-2
    learning_rate: float = 0.1
    beta: float = 0.05          # acceptance EMA window rate
    min_delta: float = 1e-20
    max_delta: float = 1e20
    adapt_on_window: bool = True  # adapt on the windowed (vs cumulative) rate
    verbose: bool = False
    print_every: int = 100


@dataclass(frozen=True)
class RunResult:
    """Outputs of `run_chain`."""
    state: Any                   # final sampler state
    stats: OnlineStats           # sampling-phase statistics
    delta: torch.Tensor          # final (adapted) delta
    samples: Optional[Any]       # stacked collected values (host NumPy), if asked
    sampling_time: float         # wall-clock seconds of the sampling phase


def _learning_rate(cfg, n_total, i):
    """cfg.learning_rate * (n_total - i) / n_total, the linearly decaying
    adaptation rate, in float32 arithmetic as the JAX loop computes it: its
    iteration index is cast to float32, and XLA folds the two constants into
    one factor, (n_total - i) * (learning_rate / n_total)."""
    f32 = np.float32
    return float((f32(n_total) - f32(i)) * (f32(cfg.learning_rate) / f32(n_total)))


def check_finite(state, delta, phase, i, n_chains=None):
    """Raise FloatingPointError if a floating tensor of `state` (its
    trajectory, log-target or log-weights) or `delta` holds a NaN or an
    infinity after iteration `i` of `phase`. With `n_chains` C, a tensor
    whose leading axis is C is a chain's each (the chain states of
    `run_sharded_chains` lead with it), and the first bad chain is named;
    a fault in any other tensor names none. One device read when all is
    finite."""
    from ..parallel.chains import _map_state
    leaves = [delta]

    def keep(z):
        if z.is_floating_point():
            leaves.append(z)
        return z
    _map_state(keep, state)
    per_chain = [n_chains is not None and z.dim() > 0 and z.shape[0] == n_chains
                 for z in leaves]
    finite = [torch.isfinite(z).reshape(n_chains, -1).all(1) if chained
              else torch.isfinite(z).all().reshape(1) for z, chained in zip(leaves, per_chain)]
    if bool(torch.cat(finite).all()):
        return
    bad = [~f for f, chained in zip(finite, per_chain) if chained]
    bad = torch.stack(bad).any(0) if bad else None
    where = ""
    if bad is not None and bool(bad.any()):
        where = f", chain {int(bad.nonzero()[0, 0])} of {n_chains}"
    name = "burn-in" if phase == _BURNIN_PHASE else "sampling"
    raise FloatingPointError(f"debug_nans: a NaN or infinity in the chain state after "
                             f"{name} iteration {i}{where}")


def _save(directory, payload, step):
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(directory, step, payload, keep=KEEP_CHECKPOINTS)


def run_chain(kernel: Callable, init_state, cfg: RunConfig, generator=None,
              collect_samples: bool = False, get_stats_x: Callable = lambda s: s.x,
              delta_init=None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, collect_fn: Callable = None,
              n_chains: Optional[int] = None, debug_nans: bool = False) -> RunResult:
    """Burn-in with adaptation, then frozen-delta sampling.

    `kernel(state, delta, generator=None) -> state`, with `state.updated` a
    scalar (MH) or per-step (T,) indicator. `delta_init` overrides
    cfg.delta_init and may be a (T,) vector: a per-step acceptance vector
    then adapts it elementwise, while a scalar delta adapts on the mean
    rate. `collect_fn` overrides what `collect_samples` records per
    iteration (default `get_stats_x`); the samples come back as one host
    NumPy array. `sampling_time` excludes burn-in.

    With `checkpoint_dir`, the loop saves its state every `checkpoint_every`
    iterations (0: at the end of each phase) and resumes from the newest
    checkpoint there, bit for bit as an uninterrupted run; `generator` must
    then be given.

    `n_chains` C: the state, delta and the kernel's `updated` carry C
    independent chains on a leading axis (`parallel.chains`); the statistics
    then count steps per chain ((C,) `step`), and a chain's delta adapts on
    its own rate (averaged over the rest of its `updated` where its delta has
    fewer axes).

    `debug_nans` (the drivers' --debug-nans, the nearest the port comes to
    `jax_debug_nans`): after every step, `check_finite` on the state and
    delta, which raises FloatingPointError naming the iteration and the
    chain where they are not finite. Off by default: it reads a flag back
    from the device each step.
    """
    if checkpoint_dir is not None and generator is None:
        raise ValueError("checkpoint_dir needs a generator of the run's own: the default "
                         "generator's state is shared with every other caller")
    collect_fn = collect_fn or get_stats_x
    x = get_stats_x(init_state)
    delta = torch.as_tensor(cfg.delta_init if delta_init is None else delta_init,
                            dtype=x.dtype, device=x.device)
    n_burn = max(cfg.burnin, 1)

    def fresh_stats(state):
        return init_stats(get_stats_x(state), accept_shape=tuple(state.updated.shape),
                          step_shape=() if n_chains is None else (n_chains,))

    phase, it, state = _BURNIN_PHASE, 0, init_state
    stats = fresh_stats(state)
    sample_buf, n_collected, sampling_time = None, 0, 0.0

    def payload():
        return {"phase": phase, "iter": it, "state": state, "delta": delta, "stats": stats,
                "samples": None if sample_buf is None else sample_buf[:n_collected].clone(),
                "n_collected": n_collected, "sampling_time": sampling_time,
                "generator": generator.get_state()}

    if checkpoint_dir is not None:
        from ..utils.checkpoint import latest_step, restore_checkpoint
        if latest_step(checkpoint_dir) is not None:
            # The samples and the generator's state stay on the host.
            target = dict(payload(), samples=torch.empty(0))
            _, saved = restore_checkpoint(checkpoint_dir, target=target)
            phase, it, sampling_time = saved["phase"], saved["iter"], saved["sampling_time"]
            state, delta, stats = saved["state"], saved["delta"], saved["stats"]
            generator.set_state(saved["generator"])
            n_collected = saved["n_collected"] if collect_samples else 0
            if n_collected:
                prev = saved["samples"]
                sample_buf = torch.empty((cfg.n_samples,) + prev.shape[1:], dtype=prev.dtype)
                sample_buf[:n_collected] = prev

    def run_phase(phase_id, n_total, adapt, collect):
        nonlocal state, delta, stats, it, sample_buf, n_collected, sampling_time
        every = n_total
        if checkpoint_dir is not None and checkpoint_every > 0:
            every = checkpoint_every
        if collect:
            every = min(every, COLLECT_SEGMENT)
        while it < n_total:
            length = min(every, n_total - it)
            seg = None
            _fence(delta)
            tic = time.perf_counter()
            for i in range(it, it + length):
                x_prev = get_stats_x(state)
                state = kernel(state, delta, generator=generator)
                if debug_nans:
                    check_finite(state, delta, phase_id, i, n_chains)
                stats = update_stats(stats, x_prev, get_stats_x(state), state.updated,
                                     beta=cfg.beta)
                if adapt:
                    rate = stats.accept_win if cfg.adapt_on_window else stats.accept_cum
                    if rate.dim() > delta.dim():
                        rate = rate.flatten(delta.dim()).mean(-1)
                    delta = delta_adaptation(delta, cfg.target_alpha, rate,
                                             _learning_rate(cfg, n_total, i),
                                             cfg.min_delta, cfg.max_delta)
                if cfg.verbose and i % cfg.print_every == 0:
                    print(f"    iter {i:>7d}  delta[{float(delta.min()):.3e},"
                          f"{float(delta.max()):.3e}]  acc_win "
                          f"{float(stats.accept_win.mean()):.3f}  acc_cum "
                          f"{float(stats.accept_cum.mean()):.3f}", flush=True)
                if collect:
                    value = collect_fn(state).detach()
                    if seg is None:
                        seg = torch.empty((length,) + value.shape, dtype=value.dtype,
                                          device=value.device)
                    seg[i - it].copy_(value)
            _fence(delta)
            if phase_id == _SAMPLE_PHASE:
                sampling_time += time.perf_counter() - tic
            it += length
            if collect:
                if sample_buf is None:
                    sample_buf = torch.empty((cfg.n_samples,) + seg.shape[1:], dtype=seg.dtype)
                sample_buf[n_collected:n_collected + length] = seg.cpu()
                n_collected += length
            if checkpoint_dir is not None:
                _save(checkpoint_dir, payload(), step=phase_id * 10 ** 9 + it)

    if phase == _BURNIN_PHASE:
        run_phase(_BURNIN_PHASE, n_burn, True, False)
        phase, it, stats = _SAMPLE_PHASE, 0, fresh_stats(state)
    run_phase(_SAMPLE_PHASE, cfg.n_samples, False, collect_samples)

    samples = None
    if collect_samples:
        samples = (sample_buf[:n_collected].numpy() if n_collected
                   else np.zeros((0,), dtype=np.float32))
    return RunResult(state=state, stats=stats, delta=delta, samples=samples,
                     sampling_time=sampling_time)
