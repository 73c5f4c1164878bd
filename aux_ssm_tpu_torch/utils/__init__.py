"""Utilities (counterpart of `aux_ssm_tpu/utils/`)."""
from .stats import OnlineStats, init_stats, update_stats, variance

__all__ = ["OnlineStats", "init_stats", "update_stats", "variance"]
