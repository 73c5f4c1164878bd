"""Inference ops of the auxiliary-Kalman MH step (counterpart of
`aux_ssm_tpu/ops/`)."""
from . import mvn
from .chol import safe_cholesky
from .lgssm import (LGSSM, log_likelihood, make_target_logpdf, posterior_logpdf,
                    prior_logpdf, trajectory_logdensity)
from .filtering import filtering
from .sampling import sampling

__all__ = [
    "mvn",
    "safe_cholesky",
    "LGSSM",
    "log_likelihood",
    "make_target_logpdf",
    "posterior_logpdf",
    "prior_logpdf",
    "trajectory_logdensity",
    "filtering",
    "sampling",
]
