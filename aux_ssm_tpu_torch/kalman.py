"""Reference-compatible namespace (counterpart of `aux_ssm_tpu/kalman.py`):
`from aux_ssm_tpu_torch.kalman import get_kernel`."""

from .kernels.kalman import KalmanSampler, get_kernel
from .ops.lgssm import LGSSM

__all__ = ["get_kernel", "KalmanSampler", "LGSSM"]
