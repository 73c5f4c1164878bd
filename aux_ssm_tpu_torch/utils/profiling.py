"""Profiling helpers (counterpart of `aux_ssm_tpu/utils/profiling.py`): a
`torch.profiler` trace, the device fence every timer goes through, and
host-side timers.
"""
import contextlib
import dataclasses
import os
import time

import torch


def first_tensor(tree):
    """The first tensor leaf of a tensor, dataclass, dict, list or tuple
    (fields and items in order); None if there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = first_tensor(item)
            if leaf is not None:
                return leaf
    return None


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (host and, on the card, device activity) and write
    a Chrome trace, `log_dir/trace.json`, viewable in Perfetto or
    chrome://tracing:

        with profiling.trace("traces/run"):
            run_chain(...)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def fence(x):
    """Wait until the device of `x`'s first tensor leaf has finished its
    queued work (nothing to wait for on the CPU). Every timer of the port
    goes through it."""
    leaf = first_tensor(x)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def timeit_ms(fn, *args, n_iter=5):
    """Median wall-clock ms of `fn(*args)` over `n_iter` calls, each fenced
    on its output; a first call (warm-up and build) is dropped."""
    fence(fn(*args))
    times = []
    for _ in range(n_iter):
        tic = time.perf_counter()
        fence(fn(*args))
        times.append(time.perf_counter() - tic)
    times.sort()
    return times[len(times) // 2] * 1e3


@contextlib.contextmanager
def timer(label="block", sync=None):
    """Host wall-clock timer; pass `sync` (a tensor or a structure of them)
    to fence its device before the clock stops. Yields a dict that gets
    `seconds` and `label`."""
    tic = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync is not None:
            fence(sync)
        box["seconds"] = time.perf_counter() - tic
        box["label"] = label
