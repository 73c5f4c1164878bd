"""Utilities (counterpart of `aux_ssm_tpu/utils/`): ESS and split-R-hat,
online chain statistics, post-run analysis, checkpointing, profiling."""
from . import analysis, checkpoint, profiling
from .ess import effective_sample_size, potential_scale_reduction, rhat_from_moments
from .stats import OnlineStats, init_stats, update_stats, variance

__all__ = ["OnlineStats", "init_stats", "update_stats", "variance", "effective_sample_size",
           "potential_scale_reduction", "rhat_from_moments", "analysis", "checkpoint",
           "profiling"]
