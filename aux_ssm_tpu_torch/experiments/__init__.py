"""Experiment loops (counterpart of `aux_ssm_tpu/experiments/`)."""
from .runner import RunConfig, RunResult, run_chain

__all__ = ["RunConfig", "RunResult", "run_chain"]
