"""Chain checkpoint/resume with `torch.save` (counterpart of
`aux_ssm_tpu/utils/checkpoint.py`, which uses orbax; the two formats are not
compatible: a checkpoint of one package cannot be read by the other).

A checkpoint holds plain data only: tensors (moved to the host), Python
numbers, strings, None, dicts and lists. Frozen dataclasses (sampler states,
`OnlineStats`) and tuples are flattened by field name and position, and
`restore_checkpoint` rebuilds them into the classes of a `target` the caller
passes, on the target's device, so `torch.load` runs with
`weights_only=True` and never unpickles a class.

A save writes `step_<k>.pt.tmp` and renames it to `step_<k>.pt` with
`os.replace`: a process killed during a save leaves the newest complete
checkpoint as it was, and `latest_step` ignores the temporary file.
"""
import dataclasses
import os
import re
from typing import Any, Optional

import torch

from .profiling import first_tensor

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _path(directory, step):
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def to_plain(tree):
    """Dataclasses to dicts of their fields, tuples to lists, tensors to
    host tensors; numbers, strings, None, dicts and lists recursively."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [to_plain(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: save tensors, numbers, "
                    "strings, None, dicts, lists, tuples and dataclasses of them")


def from_plain(data, target, device=None):
    """Rebuild `data` (from `to_plain`) into the structure and classes of
    `target`, tensors on `device`. A None in `target` takes whatever was
    saved in its place."""
    if data is None:
        return None
    if isinstance(target, torch.Tensor):
        return data.to(device=target.device)
    if isinstance(data, torch.Tensor):
        return data.to(device=device)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: from_plain(data[f.name], getattr(target, f.name), device)
            for f in dataclasses.fields(target) if f.init})
    if isinstance(target, dict):
        return {k: from_plain(v, target.get(k), device) for k, v in data.items()}
    if isinstance(target, tuple):
        items = [from_plain(v, t, device) for v, t in zip(data, target)]
        return type(target)(*items) if hasattr(target, "_fields") else tuple(items)
    if isinstance(target, list):
        return [from_plain(v, t, device) for v, t in zip(data, target)]
    return data


def save_checkpoint(directory: str, step: int, state: Any, keep: Optional[int] = None):
    """Save `state` as `directory/step_<step>.pt` (atomically: written under a
    temporary name, then renamed). With `keep`, delete all but the newest
    `keep` checkpoints afterwards. Returns the path."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.tmp"
    torch.save(to_plain(state), tmp)
    os.replace(tmp, path)
    if keep is not None:
        for old in sorted(_steps(directory))[:-keep]:
            os.remove(_path(directory, old))
    return path


def _steps(directory):
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for m in map(_STEP.match, os.listdir(directory)) if m]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, None if there is none."""
    return max(_steps(directory), default=None)


def restore_checkpoint(directory: str, step: Optional[int] = None, target: Any = None):
    """Load the checkpoint at `step` (default: the newest); returns (step,
    state). With `target`, the state is rebuilt into `target`'s structure and
    classes on the device of its first tensor; without, it is the plain data
    that was saved (dicts, lists, host tensors)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    data = torch.load(_path(directory, step), weights_only=True)
    if target is None:
        return step, data
    leaf = first_tensor(target)
    return step, from_plain(data, target, None if leaf is None else leaf.device)
