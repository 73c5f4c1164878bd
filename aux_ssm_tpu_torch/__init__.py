"""PyTorch/CUDA port of `aux_ssm_tpu`: the auxiliary-Kalman MH step, run
parallel-in-time through hand-written CUDA kernels on an NVIDIA Hopper card
(plain PyTorch on the CPU).

Float32 matmuls must stay IEEE: reduced precision (TF32 on the card) makes
the forward and reverse proposal densities disagree and collapses the MH
acceptance rate (the JAX package's `kernels/kalman.py` measured 1.00 against
0.14 with bf16 matmuls on a TPU). Importing the package turns TF32 off.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .convert import lgssm_from_numpy  # noqa: E402
from .kernels.adaptation import delta_adaptation  # noqa: E402
from .kernels.kalman import KalmanSampler, get_kernel  # noqa: E402
from .ops import (LGSSM, filtering, log_likelihood, make_target_logpdf,  # noqa: E402
                  posterior_logpdf, prior_logpdf, sampling)

__all__ = [
    "LGSSM",
    "KalmanSampler",
    "delta_adaptation",
    "filtering",
    "get_kernel",
    "lgssm_from_numpy",
    "log_likelihood",
    "make_target_logpdf",
    "posterior_logpdf",
    "prior_logpdf",
    "sampling",
]
