"""Base sampler state (counterpart of `aux_ssm_tpu/kernels/base.py`)."""
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerState:
    """Base class for sampler states: the trajectory `x`."""
    x: torch.Tensor
