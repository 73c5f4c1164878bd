"""Experiment loops and drivers (counterpart of `aux_ssm_tpu/experiments/`).

The drivers (`sv`, `spatial`, `lorenz`, `rare_event`), their shared flags (`cli`) and the
analysis artifacts (`figures`) load on first access, so that `python -m
aux_ssm_tpu_torch.experiments.<driver>` runs a module the package has not
imported already."""
import importlib

from .runner import RunConfig, RunResult, run_chain

_MODULES = ("cli", "figures", "lorenz", "rare_event", "spatial", "sv")

__all__ = ["RunConfig", "RunResult", "run_chain", *_MODULES]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
