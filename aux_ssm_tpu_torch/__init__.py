"""PyTorch/CUDA port of `aux_ssm_tpu`: the auxiliary-Kalman MH step, run
parallel-in-time, the auxiliary particle Gibbs (cSMC) of the
stochastic-volatility model, sequential or parallel-in-time (PIT), the
scalar-state particle Gibbs of the
theta-logistic (PGAS) and rare-event models, the spatio-temporal
Student-t model (auxiliary Kalman in the batched scalar layout, csmc and
csmc-guided), and the Lorenz-63 parameter-learning Gibbs sampler (with
its driver, `experiments/lorenz.py`), through hand-written CUDA
kernels on an NVIDIA Hopper card (plain PyTorch on the CPU).

Entry points that take a `device` allocate on the card when it is None
(`default_device`); a caller that wants the CPU asks for it.

Float32 matmuls must stay IEEE: reduced precision (TF32 on the card) makes
the forward and reverse proposal densities disagree and collapses the MH
acceptance rate (the JAX package's `kernels/kalman.py` measured 1.00 against
0.14 with bf16 matmuls on a TPU). Importing the package turns TF32 off.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .convert import (lgssm_from_numpy, rare_event_from_numpy,  # noqa: E402
                      rare_event_grid_from_numpy, spatial_from_numpy, sv_from_numpy,
                      theta_logistic_from_numpy)
from .device import default_device  # noqa: E402
from .experiments.runner import RunConfig, RunResult, run_chain  # noqa: E402
from .kernels.adaptation import delta_adaptation  # noqa: E402
from .kernels.base import SamplerState  # noqa: E402
from .kernels.csmc_base import CSMCState  # noqa: E402
from .kernels.kalman import KalmanSampler, get_kernel  # noqa: E402
from .models import lorenz, rare_event, spatial, stochastic_volatility, theta_logistic  # noqa: E402
from .ops import (LGSSM, filtering, log_likelihood, make_target_logpdf, mvn,  # noqa: E402
                  posterior_logpdf, prior_logpdf, sampling)
from .ops.linearise import cubature, extended, gauss_hermite  # noqa: E402

__all__ = [
    "CSMCState",
    "LGSSM",
    "KalmanSampler",
    "RunConfig",
    "RunResult",
    "SamplerState",
    "cubature",
    "default_device",
    "delta_adaptation",
    "extended",
    "filtering",
    "gauss_hermite",
    "get_kernel",
    "lgssm_from_numpy",
    "log_likelihood",
    "lorenz",
    "make_target_logpdf",
    "mvn",
    "posterior_logpdf",
    "prior_logpdf",
    "rare_event",
    "rare_event_from_numpy",
    "rare_event_grid_from_numpy",
    "run_chain",
    "sampling",
    "spatial",
    "spatial_from_numpy",
    "stochastic_volatility",
    "sv_from_numpy",
    "theta_logistic",
    "theta_logistic_from_numpy",
]
