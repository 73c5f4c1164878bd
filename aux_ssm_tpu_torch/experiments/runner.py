"""Generic MCMC experiment loop (counterpart of
`aux_ssm_tpu/experiments/runner.py`): burn-in with delta adaptation
(linearly decaying learning rate, acceptance-window EMA), then a frozen-delta
sampling phase with online EJSD/moment statistics.

The loop runs on the host, one kernel call per iteration, and never reads a
device value back except to print progress (`verbose`) or to collect
samples. The sampling phase is timed on the host clock, fenced with
`torch.cuda.synchronize()` when the state lies on the card.
Checkpointing is not ported (it needs `utils/checkpoint.py`).
"""
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels.adaptation import delta_adaptation
from ..utils.stats import OnlineStats, init_stats, update_stats


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


def _fence(x):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _learning_rate(cfg, n_total, i):
    """cfg.learning_rate * (n_total - i) / n_total, the linearly decaying
    adaptation rate, in float32 arithmetic as the JAX loop computes it: its
    iteration index is cast to float32, and XLA folds the two constants into
    one factor, (n_total - i) * (learning_rate / n_total)."""
    f32 = np.float32
    return float((f32(n_total) - f32(i)) * (f32(cfg.learning_rate) / f32(n_total)))


def run_chain(kernel: Callable, init_state, cfg: RunConfig, generator=None,
              collect_samples: bool = False, get_stats_x: Callable = lambda s: s.x,
              delta_init=None, checkpoint_dir: Optional[str] = None,
              collect_fn: Callable = None) -> RunResult:
    """Burn-in with adaptation, then frozen-delta sampling.

    `kernel(state, delta, generator=None) -> state`, with `state.updated` a
    scalar (MH) or per-step (T,) indicator. `delta_init` overrides
    cfg.delta_init and may be a (T,) vector: a per-step acceptance vector
    then adapts it elementwise, while a scalar delta adapts on the mean
    rate. `collect_fn` overrides what `collect_samples` records per
    iteration (default `get_stats_x`). `sampling_time` excludes burn-in.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpointing is not ported (it needs utils/checkpoint.py)")
    x = get_stats_x(init_state)
    delta = torch.as_tensor(cfg.delta_init if delta_init is None else delta_init,
                            dtype=x.dtype, device=x.device)
    collect_fn = collect_fn or get_stats_x
    state = init_state

    def run_phase(n_total, adapt, collect, state, delta):
        stats = init_stats(get_stats_x(state), accept_shape=tuple(state.updated.shape))
        out = []
        for i in range(n_total):
            x_prev = get_stats_x(state)
            state = kernel(state, delta, generator=generator)
            stats = update_stats(stats, x_prev, get_stats_x(state), state.updated, beta=cfg.beta)
            if adapt:
                rate = stats.accept_win if cfg.adapt_on_window else stats.accept_cum
                if rate.dim() > delta.dim():
                    rate = rate.mean()
                delta = delta_adaptation(delta, cfg.target_alpha, rate,
                                         _learning_rate(cfg, n_total, i),
                                         cfg.min_delta, cfg.max_delta)
            if cfg.verbose and i % cfg.print_every == 0:
                print(f"    iter {i:>7d}  delta[{float(delta.min()):.3e},"
                      f"{float(delta.max()):.3e}]  acc_win "
                      f"{float(stats.accept_win.mean()):.3f}  acc_cum "
                      f"{float(stats.accept_cum.mean()):.3f}", flush=True)
            if collect:
                out.append(collect_fn(state).detach().clone())
        return state, delta, stats, out

    state, delta, _, _ = run_phase(max(cfg.burnin, 1), True, False, state, delta)
    _fence(delta)
    tic = time.perf_counter()
    state, delta, stats, out = run_phase(cfg.n_samples, False, collect_samples, state, delta)
    _fence(delta)
    sampling_time = time.perf_counter() - tic

    samples = None
    if collect_samples:
        samples = (torch.stack(out).cpu().numpy() if out
                   else np.zeros((0,), dtype=np.float32))
    return RunResult(state=state, stats=stats, delta=delta, samples=samples,
                     sampling_time=sampling_time)
